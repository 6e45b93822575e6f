"""The device-plane observatory on the card: the memory tracker against
the allocator's own peak, the card's published peak and a live MFU
gauge, the dispatch round trip, and the compile probe on CUDA tensors.

Imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_profiling_cuda.py

Without a card every test skips.
"""

import pytest
import torch

from tpfl_torch.management import profiling
from tpfl_torch.management.telemetry import metrics
from tpfl_torch.settings import Settings


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_hbm_peak_is_the_allocators_peak(card):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    profiling.hbm.reset()
    x = torch.empty((64, 1 << 20), dtype=torch.uint8, device=card)  # 64 MiB
    del x
    samples = dict((d, (u, p)) for d, u, p in profiling.hbm.sample())
    dev = str(card.index)
    assert samples[dev][1] == float(torch.cuda.max_memory_allocated(card))
    assert samples[dev][0] == float(torch.cuda.memory_allocated(card))
    assert profiling.hbm.peaks()[dev] >= 64 * (1 << 20)
    assert metrics.value("tpfl_hbm_peak_bytes", {"device": dev}) == samples[dev][1]


@pytest.mark.cuda
def test_live_mfu_of_a_timed_matmul(card):
    """A bf16 matmul timed by ``best_of_wall``: its MFU against the card's
    published peak, in (0, 1], through the ``tpfl_mfu`` gauge."""
    peak = profiling.peak_flops(card)
    if peak is None:
        pytest.skip(f"no published peak for {torch.cuda.get_device_name(card)}")
    a = torch.randn((4096, 4096), dtype=torch.bfloat16, device=card)
    seconds, _ = profiling.best_of_wall(lambda m: m @ m, (a,), n=5)
    mfu = profiling.cost_model.record_round("matmul", 2.0 * 4096 ** 3, seconds, device=card)
    assert 0.0 < mfu <= 1.0
    assert metrics.value("tpfl_mfu", {"program": "matmul"}) == mfu


@pytest.mark.cuda
def test_dispatch_round_trip_and_timed_loop_on_the_card(card):
    rtt = profiling.measure_dispatch_rtt()
    assert 0.0 < rtt < 0.1
    per_iter, scalar = profiling.timed_loop(lambda c: c * 1.0 + 1.0,
                                            torch.zeros((1024,), device=card), (), 10, rtt=rtt)
    assert per_iter > 0.0 and float(scalar) == 10.0


@pytest.mark.cuda
def test_compile_probe_on_cuda_tensors(card):
    snap = Settings.snapshot()
    Settings.PROFILING_ENABLED = True
    Settings.PROFILING_RECOMPILE_WARN = 3
    profiling.observatory.reset()
    try:
        probe = profiling.observatory.wrap(lambda x: (x * 2.0).sum(), "card_probe")
        for n in (8, 8, 16, 32, 64):
            probe(torch.zeros((n,), device=card))
        assert profiling.observatory.signature_counts() == {"card_probe": 4}
    finally:
        profiling.observatory.reset()
        Settings.restore(snap)
