"""The intersection kernels' shared library (``csrc/``).

The panel kernel family (``csrc/intersect.cu``) and the family that reads
the CSR (``csrc/intersect_csr.cu``: count, per-node, support), one ``nvcc``
each, linked into one library.  Built at first use by the port's shared builder
(:class:`repro_torch.kernels._build.KernelLibrary`); nothing builds at
import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import BuildError, KernelLibrary, build_dir

__all__ = ["BuildError", "load_library", "build_info", "build_dir", "LIBRARY"]

_CSRC = Path(__file__).resolve().parent / "csrc"


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.tc_intersect_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    fn = lib.tc_intersect_csr_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


LIBRARY = KernelLibrary("tc_intersect", [_CSRC / "intersect.cu", _CSRC / "intersect_csr.cu"],
                        _declare)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it first when it is missing."""
    return LIBRARY.load()


def build_info() -> dict | None:
    """``{"path", "built", "seconds", "log"}`` of the loaded library, if any."""
    return LIBRARY.info()
