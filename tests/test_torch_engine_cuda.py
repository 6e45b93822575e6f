"""The engine's free-running seams on the card: ``dispatch_window``
returns before its window's device work ends, the telemetry carry's copy
lands in pinned host memory behind the window, the window pipeline's
prefetch stream hands its staged data over in order, and a donating
window peaks one state lower than a non-donating one, on the same bytes.

Imports torch only, so it also runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_engine_cuda.py

Without a card every test skips.
"""

import gc
import time

import numpy as np
import pytest
import torch

from tpfl_torch.models import CNN
from tpfl_torch.parallel import FederationEngine, WindowPipeline
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items, tree_map

N, NB, B = 8, 2, 32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    snap = Settings.snapshot()
    yield torch.device("cuda")
    Settings.restore(snap)


def _cell(card):
    eng = FederationEngine(CNN(out_channels=10, conv_impl="pallas"), N, device=card)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.random((N, NB, B, 32, 32, 3), np.float32)).to(card, torch.bfloat16)
    ys = torch.from_numpy(rng.integers(0, 10, (N, NB, B))).to(card)
    params = eng.init_params((32, 32, 3))
    eng.run_rounds(params, xs, ys, n_rounds=1, donate=False)  # builds and warms the kernels
    torch.cuda.synchronize()
    return eng, params, xs, ys


def _busy_card(seconds=0.5):
    """Queue ``seconds`` of device work ahead of the caller's."""
    torch.cuda._sleep(int(seconds * torch.cuda.get_device_properties(0).clock_rate * 1e3))


@pytest.mark.cuda
def test_dispatch_window_returns_before_the_window_ends(card):
    eng, params, xs, ys = _cell(card)
    start = tree_map(torch.clone, params)  # the window donates it: ref runs from params
    _busy_card(1.0)
    t0 = time.monotonic()
    handle = eng.dispatch_window(start, xs, ys, n_rounds=1)
    enqueue = time.monotonic() - t0
    assert not handle.ready(), "the window's end event completed before the queued sleep"
    handle.wait()
    assert handle.ready() and enqueue < 0.5, enqueue
    out = handle.finalize()
    ref, _ = eng.run_rounds(params, xs, ys, n_rounds=1)
    for (path, a), (_, b) in zip(tree_items(out[0]), tree_items(ref)):
        assert torch.equal(a, b), path


@pytest.mark.cuda
def test_telemetry_copy_is_pinned_and_lands_behind_the_window(card):
    Settings.ENGINE_TELEMETRY = True
    eng, params, xs, ys = _cell(card)
    _busy_card()
    handle = eng.dispatch_window(params, xs, ys, n_rounds=2)
    copy = handle._tele
    tele, w = copy._tree
    assert all(v.device.type == "cpu" and v.is_pinned() for v in (*tele.values(), w))
    assert not copy.ready()
    carry = handle.telemetry()
    assert copy.ready() and handle.ready()
    assert all(np.isfinite(v).all() for v in carry.values())
    assert (carry["participation"] == N).all() and carry["loss"].shape == (2, N)
    handle.finalize()


@pytest.mark.cuda
def test_prefetch_stream_hands_staged_data_over_in_order(card):
    """Fresh data per window staged on the prefetch thread's stream gives
    the bytes of the same data staged inline."""
    eng, params, _, _ = _cell(card)
    rng = np.random.default_rng(1)
    host = [(rng.random((N, NB, B, 32, 32, 3), np.float32), rng.integers(0, 10, (N, NB, B)))
            for _ in range(3)]

    def data_for(widx, start, k):
        _busy_card(0.05)  # the copy must wait behind the staging stream's work
        x, y = host[widx]
        return (torch.from_numpy(x).to(card, torch.bfloat16, non_blocking=True),
                torch.from_numpy(y).to(card, non_blocking=True))

    outs = []
    for prefetch in (True, False):
        (p, _), done = WindowPipeline(eng).run(tree_map(torch.clone, params), None, None,
                                               n_rounds=6, window=2,
                                               data_for=data_for, prefetch=prefetch)
        assert done == 6
        outs.append(p)
    for (path, a), (_, b) in zip(tree_items(outs[0]), tree_items(outs[1])):
        assert torch.equal(a, b), path


@pytest.mark.cuda
def test_donating_window_peaks_one_state_lower(card):
    """The full-width CNN window through the conv kernels, donating and
    not, from equal states: the outputs byte-equal, the donating window
    written in place, and its peak of requested bytes (the allocator's
    ``requested_bytes.all``, above what was requested before it; the
    allocated peak counts whole cached blocks) lower by at least the
    params state's bytes."""
    eng, params, xs, ys = _cell(card)
    state_bytes = sum(t.numel() * t.element_size() for _, t in tree_items(params))
    peaks, outs = {}, {}
    for donate in (False, True):
        p = tree_map(torch.clone, params)
        gc.collect()  # no cycle collection frees tensors inside the window
        gc.disable()
        try:
            torch.cuda.synchronize(card)
            torch.cuda.reset_peak_memory_stats(card)
            base = torch.cuda.memory_stats(card)["requested_bytes.all.current"]
            out, _ = eng.run_rounds(p, xs, ys, n_rounds=2, donate=donate)
            torch.cuda.synchronize(card)
        finally:
            gc.enable()
        peaks[donate] = torch.cuda.memory_stats(card)["requested_bytes.all.peak"] - base
        assert all((a is b) == donate for (_, a), (_, b) in zip(tree_items(out),
                                                                 tree_items(p)))
        outs[donate] = [t.cpu() for _, t in tree_items(out)]
        del p, out
    assert peaks[False] - peaks[True] >= state_bytes, (peaks, state_bytes)
    for a, b in zip(outs[True], outs[False]):
        assert torch.equal(a, b)
