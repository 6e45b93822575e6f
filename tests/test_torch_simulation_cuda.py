"""The simulation pool on the card: pooled CNN fits of a chunk of learners
through the conv kernels at the chunk's bucketed node count, allclose to
the same learners' inline fits on the card, and a ``device=None`` entry
raising without a card.

Imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_simulation_cuda.py

Without a card the pooled tests skip; the ``device=None`` test runs
everywhere (it hides the card when there is one).
"""

import threading

import numpy as np
import pytest
import torch

from tpfl_torch.learning.dataset import TpflDataset
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.learning.torch_learner import TorchLearner
from tpfl_torch.models import CNN
from tpfl_torch.models.zoo import init_params
from tpfl_torch.parallel import conv_kernel as ck
from tpfl_torch.settings import Settings
from tpfl_torch.simulation import SuperLearnerPool, VirtualNodeLearner
from tpfl_torch.utils.tree import tree_items

# f32 compute with TF32 off. cuDNN picks the grouped forward convolution's
# algorithm by the group count (the node count), so pooled and inline fits
# round differently there: the card-vs-CPU f32 tolerance of the card tests.
RTOL, ATOL = 1e-3, 1e-4
LEARNERS, SAMPLES, BATCH = 3, 64, 16  # 3 fits -> a bucket of 4 rows


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    snap = Settings.snapshot()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    SuperLearnerPool.reset()
    yield torch.device("cuda")
    SuperLearnerPool.reset()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    Settings.restore(snap)


def _learner(i, device):
    module = CNN(out_channels=10, compute_dtype=torch.float32, conv_impl="pallas")
    model = TpflModel(module, init_params(module, (32, 32, 3), seed=5, device=device),
                      device=device)
    rng = np.random.default_rng(i)
    arrays = (rng.random((SAMPLES, 32, 32, 3), np.float32),
              rng.integers(0, 10, SAMPLES).astype(np.int32),
              rng.random((8, 32, 32, 3), np.float32), rng.integers(0, 10, 8).astype(np.int32))
    return TorchLearner(model, TpflDataset.from_arrays(*arrays), addr=f"cuda-sim-{i}",
                        learning_rate=0.05, batch_size=BATCH, device=device)


def _params(learner):
    return {p: v.detach().cpu().numpy() for p, v in tree_items(learner.get_model().get_parameters())}


@pytest.mark.cuda
def test_pooled_cnn_fits_match_inline_fits_on_the_card(card):
    inline = [_learner(i, card) for i in range(LEARNERS)]
    for ln in inline:
        ln.fit()
    want = [_params(ln) for ln in inline]
    pooled = [_learner(i, card) for i in range(LEARNERS)]
    threads = [threading.Thread(target=VirtualNodeLearner(ln).fit) for ln in pooled]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    pool = SuperLearnerPool.instance()
    assert (pool.group_sizes, pool.fallbacks, pool.singles) == ([LEARNERS], 0, 0)
    for ln, w in zip(pooled, want):
        got = _params(ln)
        for path in w:
            np.testing.assert_allclose(got[path], w[path], rtol=RTOL, atol=ATOL, err_msg=path)


@pytest.mark.cuda
def test_pooled_launches_run_at_the_bucketed_node_count(card, monkeypatch):
    """One pooled fit of 3 learners: 2 conv_dw and 1 conv_dx launches a
    step, each on 4 rows (the power-of-two bucket), none at N = 1."""
    rows = []
    kernel = ck.conv_dw

    class Spy:
        """Records each launch's node count; the kernel counts its
        launches on the module's name for it, this object while it stands
        in, so the counters pass through to the kernel's own."""

        launches = property(lambda self: kernel.launches,
                            lambda self, v: setattr(kernel, "launches", v))
        wgmma_launches = property(lambda self: kernel.wgmma_launches,
                                  lambda self, v: setattr(kernel, "wgmma_launches", v))

        def __call__(self, x, g, k):
            rows.append(x.shape[0])
            return kernel(x, g, k)

    monkeypatch.setattr(ck, "conv_dw", Spy())
    learners = [_learner(i, card) for i in range(LEARNERS)]
    before = ck.conv_dx.launches
    dw_before = kernel.launches
    threads = [threading.Thread(target=VirtualNodeLearner(ln).fit) for ln in learners]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    torch.cuda.synchronize()
    steps = SAMPLES // BATCH
    assert rows == [4] * (2 * steps)
    assert kernel.launches - dw_before == 2 * steps
    assert ck.conv_dx.launches - before == steps


@pytest.mark.cuda
def test_device_none_pool_entry_raises_without_a_card(monkeypatch):
    """``device=None`` is the card: with none visible, building a learner
    for the pool raises naming ``device='cpu'``; nothing moves to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchLearner(None, None, addr="no-card", device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TpflModel(CNN(out_channels=10), None, device=None)
