"""Build and load the port's CUDA kernel libraries, at first use.

``nvcc`` compiles a family's ``csrc/*.cu`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`.  Each family
(:class:`KernelLibrary`) has one library in ``build/kernels/`` at the
root of the checkout, named by a hash of its sources and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.
Nothing here runs at import time: the port imports, and its CPU paths
run, on a machine with no ``nvcc`` and no card.
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
from typing import Callable, Sequence

__all__ = ["BuildError", "KernelLibrary", "build_dir", "FLAGS"]

FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """``nvcc`` is missing, or it refused a kernel source."""


def build_dir() -> Path:
    """``<checkout>/build/kernels`` (the package lives in ``<checkout>/src``)."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise BuildError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built on this machine"
    )


class KernelLibrary:
    """One kernel family's shared library: built once, loaded once.

    ``declare(lib)`` sets the ``argtypes``/``restype`` of the library's C
    entry points and returns the library.
    """

    def __init__(self, name: str, sources: Sequence[Path],
                 declare: Callable[[ctypes.CDLL], ctypes.CDLL], flags=FLAGS):
        self.name = name
        self.sources = tuple(Path(s) for s in sources)
        self.flags = tuple(flags)
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: ctypes.CDLL | None = None
        self._info: dict | None = None

    def digest(self) -> str:
        h = hashlib.sha256(" ".join(self.flags).encode())
        for src in self.sources:
            h.update(src.read_bytes())
        return h.hexdigest()[:16]

    def _build(self, out: Path) -> dict:
        nvcc = _nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [nvcc, *self.flags, "-o", tmp, *map(str, self.sources)]
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

    def load(self) -> ctypes.CDLL:
        """The loaded library, building it first when it is missing."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            out = build_dir() / f"lib{self.name}_{self.digest()}.so"
            info = {"built": False, "seconds": 0.0, "log": ""}
            if not out.exists():
                info = self._build(out)
            info["path"] = str(out)
            self._lib = self._declare(ctypes.CDLL(str(out)))
            self._info = info
            return self._lib

    def info(self) -> dict | None:
        """``{"path", "built", "seconds", "log"}`` of the loaded library, if any."""
        return self._info
