"""The robustness slice on the card: the port's threefry bits, Krum /
MultiKrum / TrimmedMean, the ledger's contribution stats and the
engine's ``attack_scales`` on CUDA tensors against the CPU and plain f64
versions.

Imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_robustness_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from tpfl_torch.learning.aggregators import Krum, MultiKrum, TrimmedMean
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import ledger
from tpfl_torch.models import CNN
from tpfl_torch.parallel import FederationEngine
from tpfl_torch.utils import threefry
from tpfl_torch.utils.tree import tree_items


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _models(device, n=9, outliers=(7, 8), seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        shift = 30.0 if i in outliers else 0.0
        tree = {"Conv_0": {"kernel": (rng.normal(size=(3, 3, 3, 8)) + shift).astype(np.float32),
                           "bias": rng.normal(size=(8,)).astype(np.float32)},
                "Dense_0": {"kernel": (rng.normal(size=(64, 10)) - shift).astype(np.float32),
                            "bias": rng.normal(size=(10,)).astype(np.float32)}}
        out.append(TpflModel(params=tree, num_samples=int(rng.integers(1, 9)),
                             contributors=[f"n{i}"], device=device))
    return out


def _flat64(models):
    return torch.stack([torch.cat([v.reshape(-1).double().cpu() for _, v in sorted(
        tree_items(m.get_parameters()))]) for m in models])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(7,), (3, 5, 11), (65537,), (2, 300, 1001)])
def test_threefry_bits_and_normals_card_equal_cpu(card, shape):
    key = threefry.fold_in(threefry.PRNGKey(42), 7)
    assert torch.equal(threefry.random_bits(key, shape, card).cpu(),
                       threefry.random_bits(key, shape, "cpu"))
    got, want = threefry.normal(key, shape, card).cpu(), threefry.normal(key, shape, "cpu")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _krum_pick(flat, f):
    n = flat.shape[0]
    d2 = ((flat[:, None, :] - flat[None, :, :]) ** 2).sum(-1)
    d2.fill_diagonal_(float("inf"))
    return torch.sort(d2, dim=1).values[:, :max(n - f - 2, 1)].sum(1)


@pytest.mark.cuda
def test_krum_multikrum_trimmed_mean_match_plain_f64(card):
    models = _models(card)
    flat = _flat64(models)
    scores = _krum_pick(flat, 2)
    best = int(torch.argmin(scores))
    out = Krum("k", n_byzantine=2, device=card).aggregate(models)
    assert out.get_num_samples() == models[best].get_num_samples()
    pick = dict(tree_items(models[best].get_parameters()))
    for path, v in tree_items(out.get_parameters()):
        assert torch.equal(v, pick[path]), path
    # MultiKrum: the sample-weighted f64 mean of the 4 best.
    sel = sorted(int(i) for i in torch.argsort(scores, stable=True)[:4])
    w = torch.tensor([float(models[i].get_num_samples()) for i in sel], dtype=torch.float64)
    mk = MultiKrum("k", n_byzantine=2, m=4, device=card).aggregate(models)
    for path, v in tree_items(mk.get_parameters()):
        want = sum(wi * dict(tree_items(models[i].get_parameters()))[path].double().cpu()
                   for wi, i in zip(w, sel)) / w.sum()
        torch.testing.assert_close(v.double().cpu(), want, rtol=1e-6, atol=1e-7)
    tm = TrimmedMean("t", trim=2, device=card).aggregate(models)
    for path, v in tree_items(tm.get_parameters()):
        stack = torch.stack([dict(tree_items(m.get_parameters()))[path].double().cpu()
                             for m in models])
        want = torch.sort(stack, dim=0).values[2:-2].mean(0)
        torch.testing.assert_close(v.double().cpu(), want, rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_ledger_stats_card_vs_cpu(card):
    models = _models(card, n=4, outliers=())
    ref = _models("cpu", n=1, outliers=(), seed=5)[0].get_parameters()
    acc_c = acc_g = None
    for i, m in enumerate(models):
        sg, lg, acc_g = ledger._stats(m.get_parameters(), ref, acc_g, i)
        cpu_params = {k: {n: v.cpu() for n, v in layer.items()}
                      for k, layer in m.get_parameters().items()}
        sc, lc, acc_c = ledger._stats(cpu_params, ref, acc_c, i)
        assert sg.device.type == "cuda"
        torch.testing.assert_close(sg.cpu(), sc, rtol=1e-5, atol=1e-7)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=1e-7)


@pytest.mark.cuda
def test_attack_scales_of_ones_are_bit_identical(card):
    eng = FederationEngine(CNN(channels=(4, 8), dense=16, compute_dtype=torch.float32,
                               conv_impl="pallas"), 3, seed=0, device=card)
    params = eng.init_params((8, 8, 3))
    rng = np.random.default_rng(0)
    xs = rng.uniform(size=(3, 2, 4, 8, 8, 3)).astype(np.float32)
    ys = rng.integers(0, 10, size=(3, 2, 4)).astype(np.int32)
    plain, lp = eng.run_rounds(params, xs, ys, n_rounds=2)
    ones, lo = eng.run_rounds(params, xs, ys, n_rounds=2, attack_scales=np.ones((2, 3)))
    for (path, a), (_, b) in zip(tree_items(plain), tree_items(ones)):
        assert torch.equal(a, b), path
    assert torch.equal(lp, lo)
