"""Distributed runtime of the port: for now only the int32 width guards."""
from .compression import INT32_MAX, can_narrow_int32, ensure_fits_int32

__all__ = ["INT32_MAX", "can_narrow_int32", "ensure_fits_int32"]
