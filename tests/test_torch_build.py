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
