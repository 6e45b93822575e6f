"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, loaded through :mod:`ctypes` — seconds per source,
where an extension that includes PyTorch's headers takes minutes. The
libraries go to ``build/kernels/`` at the repository root (listed in
``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import every module, and
this machine class has no ``nvcc``. A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "tpfl_torch: nvcc not found (PATH, $CUDA_HOME/bin, "
        "/usr/local/cuda/bin); the CUDA kernels cannot be built"
    )


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, every shared
    header (``csrc/*.cuh``, which any source may include) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[tuple[subprocess.Popen, Path, Path]]:
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    with open(log, "w") as fh:
        proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
    return proc, tmp, log


def _finish(name: str, job: Optional[tuple]) -> None:
    if job is None:
        return
    proc, tmp, log = job
    if proc.wait() != 0:
        raise RuntimeError(
            f"tpfl_torch: nvcc failed for csrc/{name}.cu:\n{log.read_text()}"
        )
    os.replace(tmp, _target(name))


def build(names: Iterable[str]) -> dict[str, Path]:
    """Compile the named sources, all ``nvcc`` processes started
    together, and return each library's path. Already-built sources
    are not recompiled."""
    names = list(names)
    with _lock:
        jobs = {n: _start(n) for n in names}
        for n in names:
            _finish(n, jobs[n])
    return {n: _target(n) for n in names}


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the build of ``csrc/<name>.cu``, if one ran here."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def all_sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = build([name])[name]
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
