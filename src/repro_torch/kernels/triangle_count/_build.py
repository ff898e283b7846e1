"""Build and load the intersection kernels' shared library, at first use.

``nvcc`` compiles ``csrc/intersect.cu`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`.  The library
lands in ``build/kernels/`` at the root of the checkout, named by a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import time: the
package imports, and its CPU paths run, on a machine with no ``nvcc`` and
no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["BuildError", "load_library", "build_info", "build_dir"]

_SOURCES = (Path(__file__).resolve().parent / "csrc" / "intersect.cu",)
_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_state: dict = {}


class BuildError(RuntimeError):
    """``nvcc`` is missing, or it refused the kernel source."""


def build_dir() -> Path:
    """``<checkout>/build/kernels`` (the package lives in ``<checkout>/src``)."""
    return Path(__file__).resolve().parents[4] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise BuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "intersection kernels cannot be built on this machine"
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.tc_intersect_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _build(out: Path) -> dict:
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc, *_FLAGS, "-o", tmp, *map(str, _SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise BuildError(f"could not run {nvcc}: {e}") from e
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise BuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return {"built": True, "seconds": seconds, "log": proc.stderr}


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it first when it is missing."""
    with _lock:
        lib = _state.get("lib")
        if lib is not None:
            return lib
        out = build_dir() / f"libtc_intersect_{_digest()}.so"
        info = {"built": False, "seconds": 0.0, "log": ""}
        if not out.exists():
            info = _build(out)
        info["path"] = str(out)
        lib = _declare(ctypes.CDLL(str(out)))
        _state.update(lib=lib, info=info)
        return lib


def build_info() -> dict | None:
    """``{"path", "built", "seconds", "log"}`` of the loaded library, if any."""
    return _state.get("info")
