"""Build and load the port's CUDA kernel libraries, at first use.

``nvcc`` compiles a family's ``csrc/*.cu`` for ``sm_90a``, one process per
source, all started together, and links the objects into a shared library
with a plain C interface, loaded with :mod:`ctypes`.  Each
:class:`KernelLibrary` has one library in ``build/kernels/`` at the root of
the checkout, named by a hash of the flags and of every file in its
sources' ``csrc/`` directories (the headers they include too), so an
edited source or header is rebuilt and an unchanged one is loaded as it is.
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

# compile flags of each source; the link adds -shared
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _finish(cmd: list[str], stdout: str, stderr: str, returncode: int) -> str:
    """The step's log; raises :class:`BuildError` when it failed."""
    if returncode != 0:
        raise BuildError(f"nvcc failed ({returncode}): {' '.join(cmd)}\n{stderr}")
    return stdout + stderr


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

    def inputs(self) -> list[Path]:
        """Every file the build reads: all files under the sources' directories."""
        dirs = sorted({src.parent for src in self.sources})
        return sorted(p for d in dirs for p in d.rglob("*") if p.is_file())

    def digest(self) -> str:
        h = hashlib.sha256(" ".join(self.flags).encode())
        for path in self.inputs():
            h.update(path.name.encode() + b"\0" + path.read_bytes())
        return h.hexdigest()[:16]

    def _build(self, out: Path) -> dict:
        """One ``nvcc -c`` per source, all started together, then the link."""
        nvcc = _nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            objs = [os.path.join(tmp, f"{i}_{src.stem}.o") for i, src in enumerate(self.sources)]
            steps = [[nvcc, *self.flags, "-c", "-o", obj, str(src)]
                     for src, obj in zip(self.sources, objs)]
            try:
                procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True) for cmd in steps]
            except OSError as e:
                raise BuildError(f"could not run {nvcc}: {e}") from e
            done = [(cmd, *proc.communicate()) for cmd, proc in zip(steps, procs)]
            logs = [_finish(cmd, out_, err_, proc.returncode)
                    for (cmd, out_, err_), proc in zip(done, procs)]
            lib = os.path.join(tmp, out.name)
            link = [nvcc, "-shared", "-o", lib, *objs]
            proc = subprocess.run(link, capture_output=True, text=True)
            logs.append(_finish(link, proc.stdout, proc.stderr, proc.returncode))
            os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing
        return {"built": True, "seconds": time.perf_counter() - t0, "log": "".join(logs)}

    def load(self) -> ctypes.CDLL:
        """The loaded library, building it first when it is missing.  The
        first load of each process (a build, or a load of the file) is
        recorded for :class:`repro_torch.check.runtime.CompileAuditor`."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            from repro_torch.check.runtime import record_build

            out = build_dir() / f"lib{self.name}_{self.digest()}.so"
            info = {"built": False, "seconds": 0.0, "log": ""}
            if not out.exists():
                info = self._build(out)
            info["path"] = str(out)
            self._lib = self._declare(ctypes.CDLL(str(out)))
            self._info = info
            record_build(self.name)
            return self._lib

    def info(self) -> dict | None:
        """``{"path", "built", "seconds", "log"}`` of the loaded library, if any."""
        return self._info
