"""Wire compression for cross-device collectives, and the int32 width guards.

The PyTorch counterpart of ``repro.distributed.compression``.  Two
families live in the reference:

* **Lossless int32 delta compression** for the triangle engine's
  distributed support merge (:mod:`repro_torch.core.distributed`):
  :func:`compressed_all_gather_int32` delta-transforms each stripe's
  per-edge support partials (``diff`` + zigzag), narrows the wire payload
  to uint16 when the value bound allows (:func:`can_narrow_int32`), moves
  the narrow payload to the mesh's lead device, and decodes it there with
  a cumulative sum — bit-exact by construction.  torch has no uint16
  arithmetic on every build, so the wire is ``torch.uint16`` only while it
  is stored and copied, and is widened to int32 before it is decoded.
* **Lossy int8 gradient compression** for the data-parallel all-reduce of
  the LM train step (``compressed_psum``, ``compress_grads``,
  ``make_error_feedback_state``): held for ROADMAP A7b, and each raises.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = [
    "compressed_psum",
    "make_error_feedback_state",
    "compress_grads",
    "zigzag_encode",
    "zigzag_decode",
    "can_narrow_int32",
    "ensure_fits_int32",
    "compressed_all_gather_int32",
    "INT32_MAX",
]

INT32_MAX = 2**31 - 1

_HELD_FOR_A7 = (
    "is not yet ported to repro_torch (ROADMAP A7b: the int8 gradient "
    "all-reduce of the train step); use the JAX package repro for it"
)


def compressed_psum(x, axis_name):
    """Held for ROADMAP A7b: raises."""
    raise NotImplementedError("compressed_psum " + _HELD_FOR_A7)


def make_error_feedback_state(grads):
    """Held for ROADMAP A7b: raises."""
    raise NotImplementedError("make_error_feedback_state " + _HELD_FOR_A7)


def compress_grads(grads, ef_state, axis_name):
    """Held for ROADMAP A7b: raises."""
    raise NotImplementedError("compress_grads " + _HELD_FOR_A7)


# ---------------------------------------------------------------------------
# lossless int32 delta compression (distributed support all-gather)
# ---------------------------------------------------------------------------


def zigzag_encode(d: torch.Tensor) -> torch.Tensor:
    """Map signed int32 deltas to non-negative ints (0,−1,1,−2 → 0,1,2,3).

    ``(d << 1) ^ (d >> 31)`` in int32, the shift wrapping as the
    reference's does (it is taken in int64 and narrowed).
    """
    d = d.to(torch.int64)
    return ((d << 1) ^ (d >> 63)).to(torch.int32)


def zigzag_decode(z: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`zigzag_encode`."""
    z = z.to(torch.int32)
    return (z >> 1) ^ -(z & 1)


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


def compressed_all_gather_int32(
    parts: Sequence[torch.Tensor], mesh, *, narrow: bool = True
) -> torch.Tensor:
    """Lossless delta-compressed ``all_gather`` of per-stripe int32 vectors.

    ``parts[s]`` is stripe ``s``'s rank-1 int32 vector, on its device; all
    have one length ``n``.  Each is delta-transformed (``diff`` with the
    first element kept), zigzag-encoded and narrowed to uint16 on its own
    device when ``narrow``; the wire tensors move to ``mesh.lead`` and the
    ``(S, n)`` block is decoded there by an int32 cumulative sum.  Callers
    establish the narrowing bound with :func:`can_narrow_int32`; with
    ``narrow=False`` the int32 vectors themselves travel (identical
    results, wider wire).
    """
    lead = mesh.lead
    if not narrow:
        return torch.stack([p.to(torch.int32).to(lead) for p in parts])
    wires = []
    for p in parts:
        p = p.to(torch.int32)
        d = torch.diff(p, prepend=p.new_zeros((1,)))
        wires.append(zigzag_encode(d).to(torch.uint16).to(lead))
    z = torch.stack(wires).to(torch.int32)
    # trilint: ok[overflow] — the deltas' prefix sums are the stripes' int32 partials
    return torch.cumsum(zigzag_decode(z), dim=-1, dtype=torch.int32)
