"""Wire compression for cross-device collectives, and the int32 width guards.

The PyTorch counterpart of ``repro.distributed.compression``.  Two
families live here, both on the port's single-controller
:class:`~repro_torch.distributed.Mesh`: the input is one value (or one
tree) per shard, in the mesh's device order (``mesh.devices.flat``), and
a collective's result comes back per shard, on that shard's device, where
the reference runs inside ``shard_map``.

* **Lossy int8 gradient compression** for the data-parallel all-reduce:
  :func:`compressed_psum` quantizes each shard's tensor to int8 with one
  scale shared by its group (the reference's ``pmax``), sums the int8
  payloads in int32 (the ``psum``) and dequantizes.  :func:`compress_grads`
  adds error-feedback residuals (Karimireddy et al., 2019) so the
  quantization error is carried into the next step instead of lost.  The
  groups are the shards that differ only along the named axes.
* **Lossless int32 delta compression** for the triangle engine's
  distributed support merge (:mod:`repro_torch.core.distributed`):
  :func:`compressed_all_gather_int32` delta-transforms each stripe's
  per-edge support partials (``diff`` + zigzag), narrows the wire payload
  to uint16 when the value bound allows (:func:`can_narrow_int32`), moves
  the narrow payload to the mesh's lead device, and decodes it there with
  a cumulative sum — bit-exact by construction.  torch has no uint16
  arithmetic on every build, so the wire is ``torch.uint16`` only while it
  is stored and copied, and is widened to int32 before it is decoded.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.obs.cost import record_collective
from repro_torch.optim.optimizers import tree_leaves, tree_map

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


def _groups(mesh, axis_name) -> list[list[int]]:
    """Flat shard indices of each reduction group: the shards that differ
    only along the axes ``axis_name`` names."""
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    unknown = sorted(set(names) - set(mesh.axis_names))
    if unknown:
        raise ValueError(f"axes {unknown} are not in the mesh's {mesh.axis_names}")
    idx = np.arange(mesh.size).reshape(mesh.devices.shape)
    red = [mesh.axis_names.index(a) for a in names]
    keep = [i for i in range(idx.ndim) if i not in red]
    return idx.transpose(keep + red).reshape(-1, int(np.prod([idx.shape[i] for i in red])))\
        .tolist()


def ieee_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as one correctly rounded division on every device.  With a
    Python number as divisor PyTorch's CUDA kernel multiplies by its
    reciprocal, which can be one ulp off the reference's division; a 0-d
    tensor on ``x``'s device divides."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def _check_shards(parts, mesh) -> None:
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} shard values for a mesh of {mesh.size} devices")


def _shared_scale(xs: list[torch.Tensor]) -> torch.Tensor:
    """One scalar scale shared by a group (the reference's scalar ``pmax``;
    a sum of int8 payloads quantized with different scales cannot be
    dequantized), on the group's first device."""
    lead = xs[0].device
    local = [ieee_div(torch.clamp_min(torch.amax(torch.abs(x)), 1e-12), 127.0).to(lead)
             for x in xs]
    return torch.amax(torch.stack(local))


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _residual(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x − q·scale`` rounded once to f32, as XLA computes it (a fused
    multiply-add): in float64 the product of an int8 and an f32 is exact,
    and so is the difference, which cancels to below ``scale``."""
    return (x.to(torch.float64) - q.to(torch.float64) * scale.to(torch.float64)).to(torch.float32)


def _int8_psum(qs: list[torch.Tensor]) -> torch.Tensor:
    """The int8 payloads summed in int32 on the group's first device."""
    lead = qs[0].device
    ensure_fits_int32(127 * len(qs), "an int8 payload sum")
    return torch.stack([q.to(lead) for q in qs]).sum(dim=0, dtype=torch.int64).to(torch.int32)


def compressed_psum(parts: Sequence[torch.Tensor], mesh, axis_name) -> list[torch.Tensor]:
    """``psum`` over ``axis_name`` with an int8 payload; f32 per shard.

    ``parts[s]`` is shard ``s``'s tensor, on its device, all of one shape.
    """
    _check_shards(parts, mesh)
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    record_collective("all-reduce", 4, names)  # the shared scale (the pmax)
    record_collective("all-reduce", parts[0].numel(), names)  # the int8 payload
    out: list = [None] * len(parts)
    for group in _groups(mesh, axis_name):
        xs = [parts[s].to(torch.float32) for s in group]
        scale = _shared_scale(xs)
        q_sum = _int8_psum([_quantize(x, scale.to(x.device)) for x in xs])
        for s, x in zip(group, xs):
            out[s] = q_sum.to(x.device).to(torch.float32) * scale.to(x.device)
    return out


def make_error_feedback_state(grads):
    """Zeros in f32 of every leaf's shape, on its device: one tree, or one
    per shard given a list of trees."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads)


def compress_grads(grads: Sequence, ef_state: Sequence, mesh, axis_name):
    """Error-feedback compressed gradient all-reduce over ``axis_name``.

    ``grads[s]`` and ``ef_state[s]`` are shard ``s``'s gradient tree and
    error-feedback tree.  Returns ``(synchronized grads, new error-feedback
    state)``, each a list of per-shard trees: the group's mean of the
    dequantized payloads in each gradient's dtype, and each shard's own
    quantization error.
    """
    _check_shards(grads, mesh)
    _check_shards(ef_state, mesh)
    flat_g = [tree_leaves(g) for g in grads]
    flat_e = [tree_leaves(e) for e in ef_state]
    sync = [[None] * len(f) for f in flat_g]
    new_e = [[None] * len(f) for f in flat_g]
    for group in _groups(mesh, axis_name):
        n = torch.tensor(float(len(group)), dtype=torch.float32)
        for i in range(len(flat_g[group[0]])):
            gf = [flat_g[s][i].to(torch.float32) + flat_e[s][i] for s in group]
            scale = _shared_scale(gf)
            qs = []
            for s, x in zip(group, gf):
                q = _quantize(x, scale.to(x.device))
                new_e[s][i] = _residual(x, q, scale.to(x.device))
                qs.append(q)
            q_sum = _int8_psum(qs)
            for s, x in zip(group, gf):
                g_sync = q_sum.to(x.device).to(torch.float32) * scale.to(x.device) / n.to(x.device)
                sync[s][i] = g_sync.to(flat_g[s][i].dtype)
    return ([_unflatten(g, leaves) for g, leaves in zip(grads, sync)],
            [_unflatten(g, leaves) for g, leaves in zip(grads, new_e)])


def _unflatten(tree, leaves: list):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


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
    n = parts[0].numel() if len(parts) else 0
    record_collective("all-gather", n * (2 if narrow else 4), mesh.axis_names)
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
