"""The Byzantine federation cell's verdicts in the JAX package and in the port.

    JAX_PLATFORMS=cpu python3 byzantine_reference.py [--async] [--rounds R] [--skip-jax]
        [--device cpu|cuda] [--conv-impl fwd_bwd|pallas] [--port-init] [--check-kernels]
        [--dump FILE]
    JAX_PLATFORMS=cpu python3 byzantine_reference.py [--async] --replay FILE

Runs the bench's ``byzantine`` tier recipe at the cell ``chip_smoke.py``
runs on the card, with the CNN cell's model (channels 32 / 64, dense 128,
10 classes, bf16) on the same seeded synthetic CIFAR-shaped arrays, first
in the JAX package (``tpfl``, on the CPU), then in the port
(``tpfl_torch``, on ``--device``; ``cuda`` with ``--conv-impl pallas``
runs the model through the port's conv kernels, as the card's phases do).
Both arms: ``run_seeded_experiment(seed, 10, rounds, epochs=4,
samples_per_node=200, batch_size=25, learning_rate=0.1)``, STAR,
``ELECTION = "hash"``, ``TRAIN_SET_SIZE = 10``, the test profile,
``QUARANTINE_ENABLED`` and ``LEDGER_ENABLED``.

- default, phase 14's cell: seed 4242, 6 rounds, sign flips on nodes 1
  and 4 and additive noise (std 0.1) on nodes 6 and 8;
- ``--async``, phase 16c's defended arm (the tier's async variant,
  ``bench.py:2939-3033``): seed 4243, 8 rounds, ``ASYNC_ROUNDS``
  serialized with ``ASYNC_BUFFER_K`` = 10, ``ASYNC_STALENESS_MAX`` 2 and
  ``ASYNC_STALENESS_EXP`` 0.5, ``stale_flood`` on node 1 and
  ``withhold_replay`` from round 2 on node 4.

Prints, per package, one JSON line: the ledger's flagged peers (the
deterministic verdict), the replayed quarantine decisions and set, the
peers quarantined for ``stale_flood`` and the honest peers quarantined,
each peer's range of robust z-scores of its update norm against the
defense's threshold ``LEDGER_ANOMALY_Z``, the peers flagged at intake
(the live verdicts that kept models out of the folds) with their rounds,
how many distinct final models the nodes ended with, and the honest
nodes' mean test accuracy over the last two rounds. ``--dump`` also
writes, per package, every deduped (peer, round) entry of the verdict
with its update norm, every observer's ring in intake order and the
digest of the reference each observer opened each round with.
``--port-init`` starts the JAX package from the port's initial params
for the seed (``tpfl_torch.models.init_params``), so both packages run
from one model; by default each draws its own. ``--check-kernels`` (the
port on ``cuda`` with ``pallas``) runs each conv kernel launch's plain
version on the same inputs and reports the worst difference.
``--replay FILE`` runs nothing: it replays each run of a ``--dump``
file through both packages' verdict code (``detections``,
``replay_decisions``) and says whether each gives that run's decisions.
A run takes
a few minutes on the CPU (the JAX package compiles each node's step).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import threading
import time
from collections import deque

import numpy as np
import torch

NODES, WITHHOLD_START = 10, 2
SYNC = {"seed": 4242, "rounds": 6, "adversaries": (1, 4, 6, 8)}
ASYNC = {"seed": 4243, "rounds": 8, "adversaries": (1, 4)}


def configure(settings, async_: bool) -> None:
    settings.set_test_settings()
    settings.DISABLE_SIMULATION = True
    settings.ELECTION = "hash"
    settings.TRAIN_SET_SIZE = NODES
    settings.QUARANTINE_ENABLED = settings.LEDGER_ENABLED = True
    if async_:
        settings.ASYNC_ROUNDS = settings.ASYNC_SERIALIZED = True
        settings.ASYNC_ADAPTIVE = False
        settings.ASYNC_BUFFER_K = NODES
        settings.ASYNC_STALENESS_MAX = 2
        settings.ASYNC_STALENESS_EXP = 0.5


def plan_of(attack_plan, attack_spec, async_: bool, seed: int):
    if async_:
        return attack_plan({1: attack_spec("stale_flood"),
                            4: attack_spec("withhold_replay", start=WITHHOLD_START)}, seed=seed)
    return attack_plan({1: attack_spec("sign_flip"), 4: attack_spec("sign_flip"),
                        6: attack_spec("additive_noise", std=0.1),
                        8: attack_spec("additive_noise", std=0.1)}, seed=seed)


def index(peer: str) -> int:
    return int(peer.rsplit("n", 1)[1])


def digest(leaves) -> str:
    h = hashlib.sha256()
    for leaf in leaves:
        h.update(np.ascontiguousarray(np.asarray(leaf, dtype=np.float32)).tobytes())
    return h.hexdigest()[:16]


def record_opens(ledger, leaves_of) -> list:
    """Wrap the ledger's ``open_round`` to log (node, round, reference
    digest) in call order."""
    opens, open_round = [], ledger.contrib.open_round

    def logged(node, round, ref_params):
        opens.append([node, round, digest(leaves_of(ref_params))])
        return open_round(node, round, ref_params)

    ledger.contrib.open_round = logged
    return opens


def summary(name: str, ledger, quarantine, settings, exp: str, digests, table, arm: dict,
            wall: float, dump: "dict | None", opens: list) -> dict:
    """Read while the package's settings are still the arm's (the replay
    reads ``ASYNC_STALENESS_MAX``)."""
    det = ledger.contrib.detections()
    adversaries = arm["adversaries"]
    intake: dict[str, list] = {}
    for e in ledger.contrib.entries():
        if e["single"] and e["flagged"]:
            intake.setdefault(e["peer"], []).append(int(e["round"]))
    z: dict[str, list] = {}
    for e in det["entries"]:
        z.setdefault(e["peer"], []).append(float(e["z_norm"]))
    replay = quarantine.replay_decisions()
    quarantines = [a for a in replay if a["action"] == "quarantine"]
    metrics = table(exp)
    acc = [v for node in sorted(metrics) if index(node) not in adversaries
           for _, v in metrics[node].get("test_metric", [])[-2:]]
    if dump is not None:
        dump[name] = {
            "verdict_entries": det["entries"],
            "rings": {node: [[e["peer"], e["round"], e.get("version"), e["staleness"],
                              e["update_norm"], e["z_norm"], e["reasons"]]
                             for e in ledger.contrib.entries(node) if e["single"]]
                      for node in sorted({e["node"] for e in ledger.contrib.entries()})},
            "opens": opens,
            "decisions": [[a["round"], a["peer"], a["action"], a["reasons"]] for a in replay]}
    return {"package": name, "wall_s": wall, "flagged": sorted(det["flagged"]),
            "quarantined": sorted(quarantine.quarantined_from_replay(replay)),
            "stale_flood_quarantined": sorted({a["peer"] for a in quarantines
                                               if "stale_flood" in a["reasons"]}),
            "honest_quarantined": [[a["round"], a["peer"], a["reasons"]] for a in quarantines
                                   if index(a["peer"]) not in adversaries],
            "z_range": {p: [min(v), max(v)] for p, v in sorted(z.items())},
            "ledger_anomaly_z": settings.LEDGER_ANOMALY_Z,
            "flagged_at_intake": {p: sorted(set(r)) for p, r in sorted(intake.items())},
            "honest_flagged_at_intake": sorted(
                p for p in intake if index(p) not in adversaries),
            "distinct_final_digests": len(set(digests(exp).values())),
            "honest_acc": float(sum(acc) / max(len(acc), 1)),
            "decisions": [[a["round"], a["peer"], a["action"], a["reasons"]] for a in replay]}


def run_jax(arrays, arm: dict, async_: bool, rounds: int, port_init: bool,
            dump: "dict | None") -> dict:
    import jax
    import jax.numpy as jnp

    from tpfl.attacks import AttackPlan, AttackSpec, run_seeded_experiment
    from tpfl.attacks.harness import final_model_digests, metric_table
    from tpfl.learning.dataset import TpflDataset
    from tpfl.management import ledger, quarantine
    from tpfl.management.logger import logger
    from tpfl.models import CNN, create_model
    from tpfl.settings import Settings

    configure(Settings, async_)
    logger.set_level("ERROR")
    opens = record_opens(ledger, jax.tree_util.tree_leaves)

    def model_fn(s):
        model = create_model(CNN(out_channels=10), (32, 32, 3), seed=s)
        if port_init:
            from tpfl_torch.interop import params_to_numpy
            from tpfl_torch.models import CNN as PortCNN
            from tpfl_torch.models import init_params

            model.set_parameters(jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
                init_params(PortCNN(out_channels=10), (32, 32, 3), seed=s, device="cpu"))))
        return model

    t0 = time.perf_counter()
    exp = run_seeded_experiment(
        arm["seed"], NODES, rounds, epochs=4,
        attack_plan=plan_of(AttackPlan, AttackSpec, async_, arm["seed"]), model_fn=model_fn,
        data_fn=lambda s: TpflDataset.from_arrays(*arrays), samples_per_node=200,
        batch_size=25, learning_rate=0.1, timeout=1200.0)
    return summary("tpfl (JAX)", ledger, quarantine, Settings, exp, final_model_digests,
                   metric_table, arm, time.perf_counter() - t0, dump, opens)


class Checked:
    """A conv kernel wrapper that also runs its plain version on the same
    inputs at every call (the caller goes on with the kernel's output).
    The kernel counts its launches on the module's name for it, which is
    this object while it stands in: ``launches`` and ``wgmma_launches``
    read and write the kernel's own counts."""

    launches = property(lambda self: self.kernel.launches,
                        lambda self, v: setattr(self.kernel, "launches", v))
    wgmma_launches = property(lambda self: self.kernel.wgmma_launches,
                              lambda self, v: setattr(self.kernel, "wgmma_launches", v))

    def __init__(self, kernel, plain) -> None:
        self.kernel, self.plain, self.lock = kernel, plain, threading.Lock()
        self.worst = [0, 0.0, 0.0]  # calls, max |kernel − plain|, that over max |plain|

    def __call__(self, *args):
        out = self.kernel(*args)
        want = self.plain(*args).float()
        err = (out.float() - want).abs().max().item()
        rel = err / max(want.abs().max().item(), 1e-30)
        with self.lock:
            w = self.worst
            w[0], w[1], w[2] = w[0] + 1, max(w[1], err), max(w[2], rel)
        return out


def check_kernels(conv_kernel) -> dict:
    """Stand a :class:`Checked` in for each conv kernel; returns their
    running worst errors by name."""
    conv_kernel.conv_dw = Checked(conv_kernel.conv_dw, conv_kernel.conv_dw_plain)
    conv_kernel.conv_dx = Checked(conv_kernel.conv_dx, conv_kernel.conv_dx_plain)
    return {"conv_dw": conv_kernel.conv_dw.worst, "conv_dx": conv_kernel.conv_dx.worst}


def replay_dump(path: str, async_: bool) -> None:
    """Each dumped run's deduped verdict entries, replayed through both
    packages' ``detections`` and ``replay_decisions`` on the CPU: prints,
    per run, whether each package's decisions equal the run's own."""
    from tpfl.management import ledger as jax_ledger
    from tpfl.management import quarantine as jax_quarantine
    from tpfl.settings import Settings as JaxSettings
    from tpfl_torch.management import ledger, quarantine
    from tpfl_torch.settings import Settings

    with open(path) as f:
        dump = json.load(f)
    for name, run in dump.items():
        out = {"run": name}
        for pkg, led, quar, settings in (("tpfl (JAX)", jax_ledger, jax_quarantine, JaxSettings),
                                         ("tpfl_torch", ledger, quarantine, Settings)):
            configure(settings, async_)
            led.contrib.reset()
            led.contrib._rings["replay"] = deque(dict(e, single=True)
                                                 for e in run["verdict_entries"])
            got = [[a["round"], a["peer"], a["action"], a["reasons"]]
                   for a in quar.replay_decisions()]
            led.contrib.reset()
            out[pkg] = {"same_as_run": got == run["decisions"],
                        "quarantines": [d for d in got if d[2] == "quarantine"]}
        print(json.dumps(out), flush=True)


def run_port(arrays, arm: dict, async_: bool, rounds: int, device: str, conv_impl: str,
             checked: bool, dump: "dict | None") -> dict:
    from tpfl_torch.attacks import (AttackPlan, AttackSpec, final_model_digests, metric_table,
                                    run_seeded_experiment)
    from tpfl_torch.learning.dataset import TpflDataset
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.management import ledger, quarantine
    from tpfl_torch.management.logger import logger
    from tpfl_torch.models import CNN, init_params
    from tpfl_torch.settings import Settings
    from tpfl_torch.utils.tree import canonical_leaves

    configure(Settings, async_)
    logger.set_level("ERROR")
    opens = record_opens(ledger, lambda t: [x.detach().float().cpu() for x in
                                            canonical_leaves(t)])
    if checked:
        from tpfl_torch.parallel import conv_kernel

        worst = check_kernels(conv_kernel)

    def model_fn(s):
        module = CNN(out_channels=10, conv_impl=conv_impl)
        return TpflModel(module, init_params(module, (32, 32, 3), seed=s, device=device),
                         device=device)

    t0 = time.perf_counter()
    exp = run_seeded_experiment(
        arm["seed"], NODES, rounds, epochs=4,
        attack_plan=plan_of(AttackPlan, AttackSpec, async_, arm["seed"]), model_fn=model_fn,
        data_fn=lambda s: TpflDataset.from_arrays(*arrays), samples_per_node=200,
        batch_size=25, learning_rate=0.1, timeout=1200.0, device=device)
    out = summary(f"tpfl_torch ({device}, {conv_impl})", ledger, quarantine, Settings, exp,
                  final_model_digests, metric_table, arm, time.perf_counter() - t0, dump, opens)
    if checked:
        out["kernel_vs_plain"] = worst
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="phase 16c's defended async arm instead of phase 14's cell")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds (default: 6, or 8 with --async)")
    ap.add_argument("--skip-jax", action="store_true")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--conv-impl", default="fwd_bwd", help="the port CNN's conv_impl")
    ap.add_argument("--port-init", action="store_true",
                    help="start the JAX package from the port's initial params (else flax's)")
    ap.add_argument("--check-kernels", action="store_true",
                    help="hold every conv kernel launch against its plain version")
    ap.add_argument("--dump", default=None, help="write the entries and rings here (JSON)")
    ap.add_argument("--replay", default=None,
                    help="replay a --dump file's entries in both packages instead of a run")
    args = ap.parse_args()
    if args.replay:
        replay_dump(args.replay, args.async_)
        return 0
    from tpfl_torch.learning.dataset.synthetic import synthetic_cifar10

    arm = ASYNC if args.async_ else SYNC
    rounds = args.rounds if args.rounds is not None else arm["rounds"]
    dump = {} if args.dump else None
    torch.set_num_threads(1)
    arrays = tuple(np.asarray(a) for a in synthetic_cifar10(n_train=200 * NODES, n_test=1200,
                                                            seed=arm["seed"]))
    if not args.skip_jax:
        print(json.dumps(run_jax(arrays, arm, args.async_, rounds, args.port_init, dump)),
              flush=True)
    print(json.dumps(run_port(arrays, arm, args.async_, rounds, args.device, args.conv_impl,
                              args.check_kernels, dump)), flush=True)
    if dump is not None:
        with open(args.dump, "w") as f:
            json.dump(dump, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
