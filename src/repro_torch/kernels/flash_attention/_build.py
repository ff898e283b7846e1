"""The flash-attention kernel's shared library (``csrc/flash_attention.cu``).

Built at first use by the port's shared builder
(:class:`repro_torch.kernels._build.KernelLibrary`); nothing builds at
import time.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

from .._build import BuildError, KernelLibrary

__all__ = ["BuildError", "load_library", "build_info", "LIBRARY"]


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    fn = lib.fa_forward_launch
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    smem = lib.fa_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_size_t
    return lib


LIBRARY = KernelLibrary(
    "flash_attention", [Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"], _declare
)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, building it first when it is missing."""
    return LIBRARY.load()


def build_info() -> dict | None:
    """``{"path", "built", "seconds", "log"}`` of the loaded library, if any."""
    return LIBRARY.info()
