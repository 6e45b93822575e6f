"""The kernel build's cache key (``tpfl_torch.parallel._build``): a built
library is named by a hash of its source, every shared header
(``csrc/*.cuh``) and the compiler flags, so editing any of them builds
anew instead of loading a stale library. Nothing here compiles."""

from tpfl_torch.parallel import _build


def _tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\nint k;\n')
    (csrc / "h.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_library_name_is_stable_for_unchanged_inputs(tmp_path, monkeypatch):
    _tree(tmp_path, monkeypatch)
    first = _build._target("k")
    assert _build._target("k") == first
    assert first.parent == tmp_path / "build" and first.name.startswith("libk-")


def test_library_name_follows_source_headers_and_flags(tmp_path, monkeypatch):
    csrc = _tree(tmp_path, monkeypatch)
    seen = {_build._target("k")}
    (csrc / "h.cuh").write_text("// v2\n")  # an edited header
    seen.add(_build._target("k"))
    (csrc / "g.cuh").write_text("// new\n")  # a new header
    seen.add(_build._target("k"))
    (csrc / "k.cu").write_text('#include "h.cuh"\nint k2;\n')  # the source
    seen.add(_build._target("k"))
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))  # a flag
    seen.add(_build._target("k"))
    assert len(seen) == 5


def test_launch_counts_are_exact_under_concurrent_launches():
    """``count_launch`` (what each kernel wrapper calls after a launch)
    loses no count when many threads launch at once: 8 threads × 2,000
    launches, every other one on the wgmma kernel."""
    import threading

    def wrapper():
        pass

    wrapper.launches = wrapper.wgmma_launches = 0
    start = threading.Barrier(8)

    def launch_many():
        start.wait()
        for i in range(2000):
            _build.count_launch(wrapper, i % 2)

    threads = [threading.Thread(target=launch_many) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert (wrapper.launches, wrapper.wgmma_launches) == (16_000, 8_000)


def test_first_use_from_many_threads_builds_and_loads_once(tmp_path, monkeypatch):
    """Eight threads asking for the same library at once (each node's
    first fit of a federation): one compile, one load, one handle."""
    import threading
    import time

    csrc = _tree(tmp_path, monkeypatch)
    (csrc / "k.cu").write_text("int k;\n")
    compiles, loads = [], []

    def fake_start(name):
        out = _build._target(name)
        if out.exists():
            return None
        compiles.append(name)
        time.sleep(0.2)  # a compile takes a while: the other threads pile up
        return ("job", name)

    def fake_finish(name, job):
        if job is not None:
            _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _build._target(name).write_text("built")

    def fake_cdll(path):
        loads.append(path)
        return object()

    monkeypatch.setattr(_build, "_start", fake_start)
    monkeypatch.setattr(_build, "_finish", fake_finish)
    monkeypatch.setattr(_build.ctypes, "CDLL", fake_cdll)
    monkeypatch.setattr(_build, "_libs", {})
    start = threading.Barrier(8)
    handles = []

    def first_use():
        start.wait()
        handles.append(_build.load("k"))

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert compiles == ["k"] and len(loads) == 1
    assert len(handles) == 8 and all(h is handles[0] for h in handles)
