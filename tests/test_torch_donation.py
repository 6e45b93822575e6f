"""Buffer donation in the port's engine window (``tpfl_torch.parallel.engine``)
against the JAX package's, on the CPU.

A donating window writes its state — params, SCAFFOLD's variates, aux —
in place every round and returns those tensors. The port has no lowering:
``donation_report`` / ``donation_analysis`` run the window once and count
the aliasing by storage identity, in the reference's schema. Held here:

- the report dict equal to the JAX engine's ``donation_report`` for the
  same model, params (carried across by ``params_from_flax``) and data:
  a plain CNN (f32, ``conv_impl="pallas"``: the port's plain versions, the
  JAX package's Pallas kernels in interpret mode), FedProx, SCAFFOLD, the
  BatchNorm kind with local (FedBN) and global aux, telemetry + quant8;
  a FedBuff schedule and attack scales through ``program`` +
  ``donation_analysis``, as the reference's report takes neither;
- donating against non-donating windows: bit-identical in the port, the
  non-donating one leaving its inputs intact, and the donating one within
  the kinds' tolerances of the JAX window (rtol 1e-4, atol 1e-5; under
  the q8 codec one quantisation step, as ``test_torch_engine_kinds.py``);
- which caller tensors a window writes, the autograd hazard, the
  non-donating program's report and ``program``'s signature.

3 nodes, 2 batches of 4 per node on 8×8×3 inputs, distinct per-node
params drawn by flax.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.models import CNN as JaxCNN
from tpfl.models import ResNet18 as JaxResNet18
from tpfl.parallel.engine import FedBuffSchedule as JaxSchedule
from tpfl.parallel.engine import FederationEngine as JaxEngine
from tpfl.parallel.engine import donation_analysis as jax_donation_analysis
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.interop import params_from_flax, params_to_numpy
from tpfl_torch.models import CNN, ResNet18
from tpfl_torch.parallel.engine import FedBuffSchedule, FederationEngine, donation_analysis
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import canonical_leaves, tree_items, tree_map

RTOL, ATOL = 1e-4, 1e-5
N_NODES, N_BATCHES, BATCH = 3, 2, 4

MODELS = {
    "cnn": (lambda: JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                           compute_dtype=jnp.float32, conv_impl="pallas"),
            lambda: CNN(channels=(4, 8), dense=16, out_channels=10,
                        compute_dtype=torch.float32, conv_impl="pallas")),
    "resnet": (lambda: JaxResNet18(stage_sizes=(1, 1), out_channels=10,
                                   compute_dtype=jnp.float32),
               lambda: ResNet18(stage_sizes=(1, 1), out_channels=10,
                                compute_dtype=torch.float32)),
}

#: case -> (model, engine kwargs, both packages' knobs, weights, rounds,
#: attack scales, FedBuff periods)
CASES = {
    "plain_cnn": ("cnn", {}, {}, [1.0, 0.0, 2.0], 2, None, None),
    "fedprox": ("cnn", {"algorithm": "fedprox", "prox_mu": 0.1}, {}, [1.0, 0.0, 2.0], 2,
                None, None),
    "scaffold": ("cnn", {"algorithm": "scaffold"}, {}, [1.0, 0.0, 2.0], 2, None, None),
    "fedbn_local": ("resnet", {"aux_mode": "local"}, {}, [1.0, 0.0, 2.0], 2, None, None),
    "aux_mean": ("resnet", {"aux_mode": "mean"}, {}, [1.0, 0.0, 2.0], 2, None, None),
    # One node elected, one round: the aggregate is that node's decoded
    # leaf (the kinds' one-quantisation-step bound holds).
    "telemetry_quant8": ("cnn", {}, {"ENGINE_TELEMETRY": True, "ENGINE_WIRE_CODEC": "quant8"},
                         [0.0, 0.0, 1.0], 1, None, None),
    "fedbuff": ("cnn", {}, {"ASYNC_STALENESS_EXP": 0.5}, [1.0, 1.0, 2.0], 2, None, [1, 2, 1]),
    "attack": ("cnn", {}, {}, [1.0, 0.0, 2.0], 2,
               np.asarray([[1.0, -1.0, 1.0], [1.0, 1.0, -1.0]], np.float32), None),
}
REPORTED = [c for c, v in CASES.items() if v[5] is None and v[6] is None]


@pytest.fixture(autouse=True)
def _both_settings():
    """Both packages' knobs restored, and no engine series, ledger entry or
    ``engine:`` ring of a telemetry window left behind."""
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    yield
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])
    from tpfl.management import ledger as jax_ledger
    from tpfl.management.telemetry import flight as jax_flight
    from tpfl.management.telemetry import metrics as jax_metrics
    from tpfl_torch.management import ledger, profiling
    from tpfl_torch.management.telemetry import flight, metrics

    for lg in (ledger, jax_ledger):
        lg.contrib.reset()
        lg.convergence.reset()
    profiling.rounds.reset()
    for reg in (metrics, jax_metrics):
        reg.reset()
    for ring in (flight, jax_flight):
        for node in ring.nodes():
            if node.startswith("engine:"):
                ring.clear(node)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(size=(N_NODES, N_BATCHES, BATCH, 8, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(N_NODES, N_BATCHES, BATCH)).astype(np.int32)
    return xs, ys


def _host(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _stacked_state(module):
    """Distinct per-node (params, aux) drawn by flax, as numpy trees."""
    x0 = jnp.zeros((BATCH, 8, 8, 3), jnp.float32)
    inits = [dict(module.init(jax.random.PRNGKey(s), x0, train=False))
             for s in range(N_NODES)]
    stacked = _host(jax.tree_util.tree_map(lambda *a: jnp.stack(a), *inits))
    return stacked.pop("params"), stacked


class _Case:
    """Both engines of a case and fresh window inputs for either."""

    def __init__(self, name):
        model, kw, knobs, self.weights, self.rounds, self.scales, periods = CASES[name]
        for pkg in (Settings, JaxSettings):
            for k, v in knobs.items():
                setattr(pkg, k, v)
        jax_module, torch_module = MODELS[model]
        self.jeng = JaxEngine(jax_module(), N_NODES, learning_rate=0.1, seed=0, **kw)
        self.teng = FederationEngine(torch_module(), N_NODES, learning_rate=0.1, seed=0,
                                     device="cpu", **kw)
        self.scaffold = kw.get("algorithm") == "scaffold"
        self.params, self.aux = _stacked_state(self.jeng.module)
        self.xs, self.ys = _data()
        self.periods = periods
        self.stale_exp = float(knobs.get("ASYNC_STALENESS_EXP", 0.0)) if periods else 0.0

    def port_inputs(self):
        """Fresh port state: (params, keyword arguments of a window)."""
        p = params_from_flax(self.params, device="cpu")
        kw = {"weights": self.weights, "n_rounds": self.rounds}
        if self.aux:
            kw["aux"] = params_from_flax(self.aux, device="cpu")
        if self.scaffold:
            kw["scaffold_state"] = self.teng.init_scaffold_state(p)
        return p, kw

    def jax_inputs(self):
        p = jax.tree_util.tree_map(jnp.asarray, self.params)
        kw = {"weights": jnp.asarray(self.weights, jnp.float32), "n_rounds": self.rounds}
        if self.aux:
            kw["aux"] = jax.tree_util.tree_map(jnp.asarray, self.aux)
        if self.scaffold:
            kw["scaffold_state"] = self.jeng.init_scaffold_state(p)
        return p, kw

    def window_kw(self, schedule_cls, array=np.asarray):
        kw = {}
        if self.scales is not None:
            kw["attack_scales"] = array(self.scales)
        if self.periods is not None:
            kw["schedule"] = schedule_cls.from_periods(self.periods, self.rounds)
        return kw


def _flat(result):
    """Every tensor of a port ``run_rounds`` result, in order."""
    out = []
    for part in result:
        if isinstance(part, tuple):
            for tree in part:
                out += canonical_leaves(tree)
        elif isinstance(part, dict):
            out += canonical_leaves(part)
        else:
            out.append(part)
    return out


def _storage(t):
    return t.untyped_storage().data_ptr()


@pytest.mark.parametrize("case", REPORTED)
def test_donation_report_equals_the_jax_report(case):
    """``donation_report`` of the port and of the JAX engine for the same
    window: the same dict, clean, one donated leaf per state leaf; the
    caller's tensors unchanged."""
    c = _Case(case)
    jp, jkw = c.jax_inputs()
    want = c.jeng.donation_report(jp, jnp.asarray(c.xs), jnp.asarray(c.ys), **jkw)
    tp, tkw = c.port_inputs()
    before = [t.clone() for t in _flat((tp, tkw.get("aux", {}), tkw.get("scaffold_state", ())))]
    got = c.teng.donation_report(tp, c.xs, c.ys, **tkw)
    after = _flat((tp, tkw.get("aux", {}), tkw.get("scaffold_state", ())))
    assert got == want, (got, want)
    assert got["clean"] and got["donated_leaves"] == len(after)
    assert all(torch.equal(a, b) for a, b in zip(after, before))


@pytest.mark.parametrize("case", ["fedbuff", "attack"])
def test_program_donation_analysis_equals_the_jax_analysis(case):
    """The reference's report takes no schedule and no attack scales: the
    FedBuff and attack programs of the window's cache key through
    ``program`` and ``donation_analysis`` in both packages."""
    c = _Case(case)
    a_ndim = 0 if c.scales is None else c.scales.ndim
    fedbuff = c.periods is not None
    jp, jkw = c.jax_inputs()
    jsched = JaxSchedule.from_periods(c.periods, c.rounds) if fedbuff else None
    kind, jargs, w, _ = c.jeng._prepare_args(jp, jnp.asarray(c.xs), jnp.asarray(c.ys),
                                             jkw["weights"], c.rounds, None, None, c.scales,
                                             jsched)
    jfn = c.jeng.program(kind, 1, c.rounds, w.ndim, donate=True, a_ndim=a_ndim,
                         fedbuff=fedbuff, stale_exp=c.stale_exp,
                         capacity=c.jeng.padded_nodes)
    want = jax_donation_analysis(jfn, tuple(jargs))
    tp, _ = c.port_inputs()
    tsched = FedBuffSchedule.from_periods(c.periods, c.rounds) if fedbuff else None
    kind, targs = c.teng._prepare_args(tp, c.xs, c.ys, c.weights, c.rounds, None, None,
                                       c.scales, tsched)
    tfn = c.teng.program(kind, 1, c.rounds, targs[6].dim(), donate=True, a_ndim=a_ndim,
                         fedbuff=fedbuff, stale_exp=c.stale_exp,
                         capacity=c.teng.padded_nodes)
    got = donation_analysis(tfn, tuple(targs))
    assert got == want and got["clean"], (got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_donating_window_bit_identical_and_close_to_jax(case):
    """Donating and non-donating windows from equal states: every output
    bit-identical; the non-donating window leaves its inputs as they were,
    the donating one returns its input tensors; the JAX window's outputs
    within the kinds' tolerances."""
    c = _Case(case)
    extra = c.window_kw(FedBuffSchedule)
    tp, tkw = c.port_inputs()
    inputs = _flat((tp, tkw.get("aux", {}), tkw.get("scaffold_state", ())))
    before = [t.clone() for t in inputs]
    kept = c.teng.run_rounds(tp, c.xs, c.ys, donate=False, **tkw, **extra)
    assert all(torch.equal(a, b) for a, b in zip(inputs, before))
    assert not {_storage(t) for t in _flat(kept)} & {_storage(t) for t in inputs}
    tp, tkw = c.port_inputs()
    inputs = _flat((tp, tkw.get("aux", {}), tkw.get("scaffold_state", ())))
    done = c.teng.run_rounds(tp, c.xs, c.ys, donate=True, **tkw, **extra)
    state_out = _flat(done)[:-1]  # the losses are new
    assert [_storage(t) for t in state_out] == [_storage(t) for t in inputs]
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(_flat(done), _flat(kept)))
    jp, jkw = c.jax_inputs()
    want = c.jeng.run_rounds(jp, jnp.asarray(c.xs), jnp.asarray(c.ys),
                             **jkw, **c.window_kw(JaxSchedule, jnp.asarray))
    got_leaves = _flat(done)
    want_leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(want)]
    assert len(got_leaves) == len(want_leaves)
    codec = Settings.ENGINE_WIRE_CODEC != "dense"
    for i, (g, w) in enumerate(zip(got_leaves, want_leaves)):
        g = g.detach().numpy()
        if codec and i < len(canonical_leaves(tp)):
            step = float(np.abs(w).max()) / 127.0
            np.testing.assert_allclose(g, w, rtol=0, atol=step * (1 + 2 ** -10), err_msg=str(i))
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=str(i))


def test_which_caller_tensors_a_window_writes():
    """A caller's padded tensor on the engine's device comes back as the
    output, written in place; a numpy tree, a tree of fewer rows than
    the padded axis (padding copies it), a tensor that requires grad, a
    non-contiguous tensor and a leaf sharing another's storage are
    copied once on entry and left as they were."""
    _, torch_module = MODELS["cnn"]
    eng = FederationEngine(torch_module(), N_NODES, learning_rate=0.1, seed=0, device="cpu")
    xs, ys = _data()
    p = eng.init_params((8, 8, 3))
    ptrs = [_storage(t) for t in canonical_leaves(p)]
    out, _ = eng.run_rounds(p, xs, ys)
    assert [_storage(t) for t in canonical_leaves(out)] == ptrs
    assert all(a is b for a, b in zip(canonical_leaves(out), canonical_leaves(p)))

    def untouched(make):
        tree = make()
        before = [np.array(t.detach() if isinstance(t, torch.Tensor) else t)
                  for t in canonical_leaves(tree)]
        res, _ = eng.run_rounds(tree, xs, ys)
        assert all(np.array_equal(np.asarray(t.detach() if isinstance(t, torch.Tensor) else t),
                                  b) for t, b in zip(canonical_leaves(tree), before))
        return res

    untouched(lambda: params_to_numpy(eng.init_params((8, 8, 3))))
    untouched(lambda: tree_map(lambda t: t.detach().requires_grad_(True),
                               eng.init_params((8, 8, 3))))
    untouched(lambda: tree_map(lambda t: t.transpose(0, -1).contiguous().transpose(0, -1)
                               if t.dim() > 1 else t, eng.init_params((8, 8, 3))))
    wide = FederationEngine(torch_module(), N_NODES + 1, learning_rate=0.1, seed=0,
                            device="cpu")
    three = eng.init_params((8, 8, 3))
    before = [t.clone() for t in canonical_leaves(three)]
    wide_out, _ = wide.run_rounds(three, np.concatenate([xs, xs[:1]]),
                                  np.concatenate([ys, ys[:1]]))
    assert all(torch.equal(a, b) for a, b in zip(canonical_leaves(three), before))
    assert next(iter(canonical_leaves(wide_out))).shape[0] == N_NODES + 1
    # Two contiguous state leaves on one storage: the second is copied, so
    # each output leaf has a storage of its own.
    shared = eng.init_params((8, 8, 3))
    a, b = shared["Dense_0"]["bias"], shared["Dense_1"]["bias"]
    buf = torch.cat([a.reshape(-1), b.reshape(-1)])
    shared["Dense_0"]["bias"] = buf[:a.numel()].view(a.shape)
    shared["Dense_1"]["bias"] = buf[a.numel():].view(b.shape)
    res, _ = eng.run_rounds(shared, xs, ys)
    assert len({_storage(t) for t in canonical_leaves(res)}) == len(canonical_leaves(res))
    assert res["Dense_0"]["bias"] is shared["Dense_0"]["bias"]
    # donate=False writes no input.
    q = eng.init_params((8, 8, 3))
    before = [t.clone() for t in canonical_leaves(q)]
    out, _ = eng.run_rounds(q, xs, ys, donate=False)
    assert all(torch.equal(a, b) for a, b in zip(canonical_leaves(q), before))
    assert not {_storage(t) for t in canonical_leaves(out)} & {
        _storage(t) for t in canonical_leaves(q)}


def test_no_donated_leaf_is_written_while_saved_for_backward():
    """Every tensor the conv and dense autograd functions save for a
    backward is unpacked at the version it was saved at: the fold writes a
    donated leaf only after the backwards that read it ran. The check has
    teeth: the first step saves the donated params' own storage, and the
    window does write it."""
    _, torch_module = MODELS["cnn"]
    eng = FederationEngine(torch_module(), N_NODES, learning_rate=0.1, seed=0, device="cpu",
                           algorithm="fedprox", prox_mu=0.1)
    p = eng.init_params((8, 8, 3))
    donated = {_storage(t) for t in canonical_leaves(p)}
    versions = [t._version for t in canonical_leaves(p)]
    seen = []

    def pack(t):
        return t, t._version, _storage(t) in donated

    def unpack(packed):
        t, version, is_donated = packed
        if is_donated:
            seen.append(t._version == version)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, unpack):
        out, _ = eng.run_rounds(p, *_data(), n_rounds=2, donate=True)
    assert seen and all(seen), seen
    assert all(a is b for a, b in zip(canonical_leaves(out), canonical_leaves(p)))
    assert all(t._version > v for t, v in zip(canonical_leaves(p), versions))


def test_donation_analysis_flags_non_donating_program():
    """The counterpart of the reference's case: a ``donate=False`` program
    aliases nothing, so its report is not clean; and it is the JAX
    report's dict."""
    c = _Case("plain_cnn")
    jp, _ = c.jax_inputs()
    jfn = c.jeng.program("plain", 1, 2, 1, donate=False)
    jdx, jdy = c.jeng.shard_data(c.xs, c.ys)
    want = jax_donation_analysis(jfn, (jp, {}, {}, {}, jdx, jdy, c.jeng.pad_weights(None),
                                       c.jeng.valid))
    tp, _ = c.port_inputs()
    fn = c.teng.program("plain", 1, 2, 1, donate=False)
    dx, dy = c.teng.shard_data(c.xs, c.ys)
    got = donation_analysis(fn, (tp, {}, {}, {}, dx, dy, c.teng.pad_weights(None),
                                 c.teng.valid))
    assert not got["clean"]
    assert got["aliased"] == 0 and got["output_aliases"] == 0
    assert got == want


def test_program_has_the_reference_signature_and_cache_slots():
    """``program`` takes the reference's arguments with its defaults; a
    key is one cache slot (``donate`` a slot of its own) shared with the
    dispatch of the same window; its callable runs the window in the
    reference's positional order."""
    port = inspect.signature(FederationEngine.program).parameters
    ref = inspect.signature(JaxEngine.program).parameters
    assert [(k, v.default) for k, v in port.items()] == [(k, v.default) for k, v in ref.items()]
    c = _Case("plain_cnn")
    tp, _ = c.port_inputs()
    dx, dy = c.teng.shard_data(c.xs, c.ys)
    w = c.teng.pad_weights(None)
    c.teng.run_rounds(params_from_flax(c.params, device="cpu"), c.xs, c.ys, n_rounds=2)
    slots = set(c.teng._programs)
    key = next(iter(slots))
    fn = c.teng.program(*key)
    assert set(c.teng._programs) == slots and fn.donates
    c.teng.program(*key[:4], False, *key[5:])
    assert len(c.teng._programs) == len(slots) + 1
    out = fn(tp, {}, {}, {}, dx, dy, w, c.teng.valid)
    ref, losses = c.teng.run_rounds(params_from_flax(c.params, device="cpu"), c.xs, c.ys,
                                    n_rounds=2)
    assert len(out) == 5 and out[1] == out[2] == out[3] == {}
    assert all(torch.equal(a, b) for a, b in zip(canonical_leaves(out[0]),
                                                 canonical_leaves(ref)))
    assert torch.equal(out[4], losses)
    assert dict(tree_items(out[0])).keys() == dict(tree_items(tp)).keys()
