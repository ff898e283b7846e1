"""Integer-width guards shared by the ingest, plan and engine layers.

The port keeps only the two host-side bound checks of the reference's
compression module; the delta-compressed ``all_gather`` arrives with the
distributed slice.
"""
from __future__ import annotations

__all__ = ["INT32_MAX", "ensure_fits_int32", "can_narrow_int32"]

INT32_MAX = 2**31 - 1


def ensure_fits_int32(value: int, what: str = "value") -> int:
    """Loud bound check before narrowing an index-scale value to int32.

    The ingest/plan layers store edge indices and CSR offsets as int32 for
    device-side compactness; ``.astype(np.int32)`` alone *wraps* once the
    graph crosses 2³¹ directed edges.  Every such narrowing routes through
    this guard so m >= 2³¹ fails with a diagnosis instead of corrupting
    counts.
    """
    v = int(value)
    if not 0 <= v <= INT32_MAX:
        raise OverflowError(
            f"{what} = {v} does not fit int32 (max {INT32_MAX}); this graph "
            "needs the int64 index path, narrowing would wrap silently"
        )
    return v


def can_narrow_int32(bound: int) -> bool:
    """Can values in ``[0, bound]`` ride a uint16 wire after delta+zigzag?

    Deltas of such values lie in ``[-bound, bound]``; zigzag maps them to
    ``[0, 2·bound]``, so the narrow wire is lossless iff ``2·bound < 2¹⁶``.
    """
    return 0 <= 2 * int(bound) <= 0xFFFF
