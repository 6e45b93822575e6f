"""The port's learner (tpfl_torch.learning.torch_learner.TorchLearner) and
dataset layer against the JAX package's JaxLearner / TpflDataset, on the
CPU.

- ``Batches.stacked`` (incl. the uint32 seed wrap) and the export's
  column and dtype rules give the JAX package's arrays; ``set_split``
  picks the rows of HF's ``train_test_split``.
- ``TorchLearner.fit`` against ``JaxLearner.fit`` from the same params
  and data, two consecutive fits (the second reshuffles): the CNN under
  ``conv_impl="pallas"`` (JAX's Pallas conv backward in interpret mode)
  and ``"fwd_bwd"``, the MLP, ResNet-18 with BatchNorm ``aux_state``,
  and the FedProx and SCAFFOLD callbacks (variates and shipped info).
  f32 compute; rtol 1e-4, atol 1e-5 (reduction order only).
- ``evaluate`` with a ragged tail gives the same metrics.
- ``skip_fit``, zero epochs and ``interrupt_fit`` behave as
  ``tests/test_learner.py`` has the reference behave.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpfl.learning.aggregators import FedProx as JaxFedProx
from tpfl.learning.aggregators import Scaffold as JaxScaffold
from tpfl.learning.dataset import TpflDataset as JaxDataset
from tpfl.learning.dataset.export import Batches as JaxBatches
from tpfl.learning.jax_learner import JaxLearner
from tpfl.models import CNN as JaxCNN
from tpfl.models import MLP as JaxMLP
from tpfl.models import ResNet18 as JaxResNet18
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.interop import model_state_from_jax, params_to_numpy
from tpfl_torch.learning.aggregators import FedProx, Scaffold
from tpfl_torch.learning.dataset import Batches, TpflDataset
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.learning.torch_learner import TorchLearner
from tpfl_torch.models import CNN, MLP, ResNet18
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items

RTOL, ATOL = 1e-4, 1e-5

MODELS = {
    "cnn_pallas": (lambda: JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                                  compute_dtype=jnp.float32, conv_impl="pallas"),
                   lambda: CNN(channels=(4, 8), dense=16, out_channels=10,
                               compute_dtype=torch.float32, conv_impl="pallas")),
    "cnn_fwd_bwd": (lambda: JaxCNN(channels=(4, 8), dense=16, out_channels=10,
                                   compute_dtype=jnp.float32, conv_impl="fwd_bwd"),
                    lambda: CNN(channels=(4, 8), dense=16, out_channels=10,
                                compute_dtype=torch.float32, conv_impl="fwd_bwd")),
    "mlp": (lambda: JaxMLP(hidden_sizes=(16, 8), out_channels=10, compute_dtype=jnp.float32),
            lambda: MLP(hidden_sizes=(16, 8), out_channels=10, compute_dtype=torch.float32)),
    "resnet": (lambda: JaxResNet18(stage_sizes=(1, 1), out_channels=10,
                                   compute_dtype=jnp.float32),
               lambda: ResNet18(stage_sizes=(1, 1), out_channels=10,
                                compute_dtype=torch.float32)),
}


def _arrays(seed=0, n_train=40, n_test=13):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n_train, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 10, n_train).astype(np.int32),
            rng.uniform(size=(n_test, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 10, n_test).astype(np.int32))


def _pair(model, aggs=(None, None), addr="node-0", seed=0, **kw):
    """A JaxLearner and a TorchLearner over the same params and data."""
    jax_module, torch_module = MODELS[model]
    jm = jax_create_model(jax_module(), (8, 8, 3), seed=seed)
    state = model_state_from_jax(jm, device="cpu")
    tm = TpflModel(module=torch_module(), **state)
    arrays = _arrays(seed)
    jl = JaxLearner(jm, JaxDataset.from_arrays(*arrays), addr=addr, aggregator=aggs[0],
                    learning_rate=0.1, batch_size=8, **kw)
    tl = TorchLearner(tm, TpflDataset.from_arrays(*arrays), addr=addr, aggregator=aggs[1],
                      learning_rate=0.1, batch_size=8, device="cpu", **kw)
    return jl, tl


def _numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _assert_tree_close(got, want, what):
    got = dict(tree_items(params_to_numpy(got)))
    want = dict(tree_items(_numpy(want)))
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL, err_msg=f"{what} {k}")


# --- data ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,epoch", [(0, 0), (7, 10_001), (2**32 - 3, 5)])
@pytest.mark.parametrize("num_batches", [None, 2])
def test_batches_stacked_match(seed, epoch, num_batches):
    x, y, _, _ = _arrays(1)
    want = JaxBatches(x, y, 8, seed=seed).stacked(num_batches=num_batches, epoch=epoch)
    got = Batches(x, y, 8, seed=seed).stacked(num_batches=num_batches, epoch=epoch)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,fraction,seed", [(100, 0.8, 666), (37, 0.7, 3), (10, 0.55, 0),
                                             (7, 0.9, 1)])
def test_set_split_picks_hf_rows(n, fraction, seed):
    ids = np.arange(n, dtype=np.int64)
    jd = JaxDataset({"image": ids, "label": ids % 3})
    td = TpflDataset({"image": ids, "label": ids % 3})
    jd.set_split(fraction, seed=seed)
    td.set_split(fraction, seed=seed)
    for train in (True, False):
        np.testing.assert_array_equal(td.get_split(train)["image"],
                                      np.asarray(jd.get_split(train)["image"]))
        assert td.num_samples(train) == jd.num_samples(train)
    assert int(td.get(0)["image"]) == jd.get(0)["image"]


@pytest.mark.parametrize("kw", [{}, {"scale": 1 / 255.0}, {"flatten": True},
                                {"drop_remainder": False, "x_dtype": np.float32}])
@pytest.mark.parametrize("kind", ["float", "uint8", "tokens"])
def test_export_rules_match(kind, kw):
    rng = np.random.default_rng(5)
    x = {"float": rng.uniform(size=(20, 4, 4, 2)).astype(np.float32),
         "uint8": rng.integers(0, 256, size=(20, 4, 4)).astype(np.uint8),
         "tokens": rng.integers(0, 50, size=(20, 6)).astype(np.int32)}[kind]
    y = rng.integers(0, 4, 20).astype(np.int32)
    jb = JaxDataset.from_arrays(x, y, x[:5], y[:5]).export(batch_size=6, train=True, **kw)
    tb = TpflDataset.from_arrays(x, y, x[:5], y[:5]).export(batch_size=6, train=True, **kw)
    assert tb.x.dtype == jb.x.dtype and tb.y.dtype == jb.y.dtype
    np.testing.assert_array_equal(tb.x, jb.x)
    np.testing.assert_array_equal(tb.y, jb.y)
    assert len(tb) == len(jb)


def test_dataset_seams_not_ported_raise():
    """The HF-hub constructors are not ported (the partition strategies
    are: tests/test_torch_partitions.py)."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TpflDataset.from_huggingface("mnist")


# --- fit / evaluate --------------------------------------------------------------


@pytest.mark.parametrize("model", list(MODELS))
def test_fit_matches_jax_learner(model):
    jl, tl = _pair(model)
    for _ in range(2):
        jm, tm = jl.fit(), tl.fit()
        _assert_tree_close(tm.get_parameters(), jm.get_parameters(), model)
        assert tm.get_contributors() == jm.get_contributors() == ["node-0"]
        assert tm.get_num_samples() == jm.get_num_samples() == 40
    if model == "resnet":
        _assert_tree_close(tm.aux_state, jm.aux_state, "aux")
    assert tl.evaluate() == pytest.approx(jl.evaluate(), rel=RTOL, abs=ATOL)


def test_fit_with_fedprox_callback_matches():
    jl, tl = _pair("mlp", aggs=(JaxFedProx("a", proximal_mu=0.5),
                                FedProx("a", proximal_mu=0.5, device="cpu")))
    assert [cb.prox_mu() for cb in tl.callbacks] == [cb.prox_mu() for cb in jl.callbacks] == [0.5]
    for _ in range(2):
        jm, tm = jl.fit(), tl.fit()
        _assert_tree_close(tm.get_parameters(), jm.get_parameters(), "fedprox")
    assert tm.get_info("fedprox") == jm.get_info("fedprox") == {"mu": 0.5}


@pytest.mark.parametrize("model", ["mlp", "cnn_pallas"])
def test_fit_with_scaffold_callback_matches(model):
    jagg, tagg = JaxScaffold("a"), Scaffold("a", device="cpu")
    jl, tl = _pair(model, aggs=(jagg, tagg))
    for rnd in range(2):
        jm, tm = jl.fit(), tl.fit()
        _assert_tree_close(tm.get_parameters(), jm.get_parameters(), f"params {rnd}")
        for key in ("delta_y_i", "delta_c_i"):
            _assert_tree_close(tm.get_info("scaffold")[key], jm.get_info("scaffold")[key], key)
        _assert_tree_close(tl.callbacks[0].c_i, jl.callbacks[0].c_i, "c_i")
        # The aggregate's global_c goes back into each learner's callback.
        jagg.set_nodes_to_aggregate(["node-0"])
        jagg.add_model(jm)
        tagg.set_nodes_to_aggregate(["node-0"])
        tagg.add_model(tm)
        jout, tout = jagg.wait_and_get_aggregation(timeout=5), tagg.wait_and_get_aggregation(
            timeout=5)
        _assert_tree_close(tout.get_info("scaffold")["global_c"],
                           jout.get_info("scaffold")["global_c"], "global_c")
        jl.set_model(jout)
        tl.set_model(tout)
        jagg.clear()
        tagg.clear()
    _assert_tree_close(tl.get_model().get_parameters(), jl.get_model().get_parameters(), "x")


def test_scaffold_callback_takes_wire_global_c():
    """global_c that arrived over the wire (numpy leaves) corrects the
    gradients as the tensors it came from would."""
    jagg, tagg = JaxScaffold("a"), Scaffold("a", device="cpu")
    jl, tl = _pair("mlp", aggs=(jagg, tagg))
    jm, tm = jl.fit(), tl.fit()
    tagg.set_nodes_to_aggregate(["node-0"])
    tagg.add_model(tm)
    payload = tagg.wait_and_get_aggregation(timeout=5).encode_parameters()
    jl.set_model(payload)
    tl.set_model(payload)
    _assert_tree_close(tl.fit().get_parameters(), jl.fit().get_parameters(), "after wire")


def test_evaluate_ragged_tail_matches():
    x, y, _, _ = _arrays(3)
    xt, yt = x[:21], y[:21]  # 21 % 8 != 0
    jl, tl = _pair("cnn_fwd_bwd")
    jl.set_data(JaxDataset.from_arrays(x, y, xt, yt))
    tl.set_data(TpflDataset.from_arrays(x, y, xt, yt))
    want, got = jl.evaluate(), tl.evaluate()
    assert set(got) == set(want)
    assert got == pytest.approx(want, rel=RTOL, abs=ATOL)
    xs, ys, ms = tl._eval_batches()
    assert int(ms.sum()) == 21 and tuple(xs.shape[:2]) == (3, 8)


def test_zero_epochs_leaves_model_untouched_with_zero_weight():
    jl, tl = _pair("mlp")
    start = params_to_numpy(tl.get_model().get_parameters())
    tl.set_epochs(0)
    jl.set_epochs(0)
    tmodel, jmodel = tl.fit(), jl.fit()
    for (k, s), (_, e) in zip(tree_items(start),
                              tree_items(params_to_numpy(tl.get_model().get_parameters()))):
        np.testing.assert_array_equal(s, e, err_msg=k)
    assert tmodel.get_num_samples() == jmodel.get_num_samples() == 0
    assert tmodel.get_contributors() == ["node-0"]


def test_interrupt_fit_stops_after_current_epoch():
    _, tl = _pair("mlp")
    tl.set_epochs(5)
    orig = tl._build_train_epoch()
    calls = []

    def wrapper(state, xs, ys, *rest):
        calls.append(1)
        tl.interrupt_fit()  # lands mid-fit, checked next epoch
        return orig(state, xs, ys, *rest)

    tl._train_epoch_fn = wrapper
    model = tl.fit()
    assert len(calls) == 1
    assert model.get_num_samples() == 40  # the completed epoch counts
    tl.reset_interrupt()
    assert not tl._interrupt.is_set()


def test_skip_fit_strips_stale_callback_info():
    _, tl = _pair("mlp", aggs=(None, Scaffold("t", device="cpu")))
    fitted = tl.fit()
    assert fitted.get_info("scaffold")
    skipped = tl.skip_fit(fitted)
    assert skipped.get_num_samples() == 0
    assert skipped.get_info().get("scaffold") is None
    assert fitted.get_info("scaffold")  # the fitted model is untouched


def test_fit_reproducible_per_addr_and_seed():
    snap = (Settings.SEED, JaxSettings.SEED)
    try:
        Settings.SEED = JaxSettings.SEED = 11
        jl, tl = _pair("mlp", addr="node-x")
        _assert_tree_close(tl.fit().get_parameters(), jl.fit().get_parameters(), "seeded")
        _, other = _pair("mlp", addr="node-y")
        a = params_to_numpy(other.fit().get_parameters())["Dense_0"]["kernel"]
        b = params_to_numpy(tl.get_model().get_parameters())["Dense_0"]["kernel"]
        assert not np.allclose(a, b)
    finally:
        Settings.SEED, JaxSettings.SEED = snap
