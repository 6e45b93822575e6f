"""Static scaling analysis — the port of :mod:`tpfl.parallel.scaling`.

Wall-clock tables over ranks that share one CPU say nothing, so the
sharding claims are proven from what one rank's step does, at several
mesh widths:

- per-rank FLOPs fall ~1/d (the compute is partitioned);
- the bytes the collectives move are O(model params) and independent of
  the node count or the batch (one all-reduce of the aggregate, not a
  gather of per-node replicas).

The reference reads both from compiled HLO. The port has no HLO: every
collective it issues goes through a helper of
:mod:`tpfl_torch.parallel.distributed`, which records ``(kind, bytes)``
into the collective ledger, and the FLOPs come from the shared
:class:`~tpfl_torch.management.profiling.CostModel`
(``torch.utils.flop_counter``) — the one path, so scaling analysis and
live MFU never disagree about what a program costs. ``FlopCounterMode``
does not see a kernel launched through ``ctypes``: on CPU tensors the
kernels' plain versions run and are counted, on CUDA tensors they are
not — run the analysis on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable

from tpfl_torch.management.profiling import cost_model
from tpfl_torch.parallel import distributed as spmd
from tpfl_torch.utils.tree import tree_leaves

__all__ = ["analyze", "check_scaling", "collective_bytes", "params_bytes"]

_COLLECTIVES = spmd.COLLECTIVE_KINDS


def collective_bytes(events: "spmd.CollectiveLedger | Iterable[tuple[str, int]]") -> dict[str, int]:
    """Bytes delivered by each collective kind: a ledger of
    :func:`~tpfl_torch.parallel.distributed.record_collectives`, or its
    ``(kind, bytes)`` events (the reference's ``collective_bytes`` over
    HLO result shapes)."""
    if isinstance(events, spmd.CollectiveLedger):
        events = events.events
    out: dict[str, int] = {}
    for kind, nbytes in events:
        if kind not in _COLLECTIVES:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[kind] = out.get(kind, 0) + int(nbytes)
    return out


def analyze(fn: Callable[..., Any], *args: Any, **kwargs: Any) -> dict[str, Any]:
    """One run of ``fn(*args, **kwargs)`` on this rank — a step, or a
    window — under the collective ledger and the cost model:
    ``{"flops": this rank's FLOPs, "collectives": {kind: bytes},
    "collective_bytes": total, "result": fn's return}`` (the reference's
    ``analyze_compiled``). Every rank of the step's groups must call it
    together."""
    out: list = []
    with spmd.record_collectives() as ledger:
        flops = cost_model.xla_flops(lambda: out.append(fn(*args, **kwargs)))
    coll = collective_bytes(ledger)
    return {"flops": flops or 0.0, "collectives": coll,
            "collective_bytes": sum(coll.values()), "result": out[0]}


def params_bytes(tree: Any) -> int:
    """Bytes of a tree's tensors (a placed leaf counts its whole global
    shape)."""
    return sum(int(t.numel()) * t.element_size() for t in tree_leaves(tree))


def check_scaling(records: list[dict], params_nbytes: int, flops_tol: float = 0.25,
                  collective_factor: float = 4.0) -> list[str]:
    """The scaling conditions over per-width analysis records ``[{"width":
    d, "flops": F_d, "collective_bytes": C_d}, ...]``; returns the
    failures (empty = pass), as the reference's:

    - F_d · d within ``flops_tol`` of the base width's work (per-rank
      compute ∝ 1/d; the slack absorbs padding and the O(params) fold);
    - for d > 1: C_d ≤ ``collective_factor`` · ``params_nbytes`` (the
      reduction moves O(params), never O(params · nodes)), and C_d is
      width-independent within 2× (no hidden re-replication)."""
    failures: list[str] = []
    base = next((r for r in records if r["width"] == 1), records[0])
    base_work = base["flops"] * base["width"]
    for r in records:
        work = r["flops"] * r["width"]
        if not base_work * (1 - flops_tol) <= work <= base_work * (1 + flops_tol):
            failures.append(
                f"width {r['width']}: per-device flops x width = {work:.0f} not within "
                f"{flops_tol:.0%} of base work {base_work:.0f} — compute is not "
                f"1/d-partitioned")
    multi = [r for r in records if r["width"] > 1]
    for r in multi:
        if r["collective_bytes"] > collective_factor * params_nbytes:
            failures.append(
                f"width {r['width']}: collective bytes {r['collective_bytes']} exceed "
                f"{collective_factor}x params ({params_nbytes} B) — reduction is not "
                f"O(params)")
    if multi:
        cs = [r["collective_bytes"] for r in multi]
        if max(cs) > 2 * max(1, min(cs)):
            failures.append(
                f"collective bytes vary {min(cs)}..{max(cs)} across widths — hidden "
                f"width-dependent re-replication")
    return failures
