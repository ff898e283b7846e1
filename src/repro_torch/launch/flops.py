"""Cost walker: FLOPs and logical memory traffic of a step, op by op.

The port's counterpart of ``repro.launch.flops``.  The reference walks the
jaxpr of a step; the port has no jaxpr, so :class:`CostWalker` is a
``TorchDispatchMode`` that sees every aten op the step runs — forward,
backward, and the forward that ``torch.utils.checkpoint`` replays in the
backward, so recompute is counted — and applies the reference's rules:

* ``flops`` — exact for the matmul family (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, …: 2·M·N·K under ``by_prim["dot_general"]``; a fused bias
  add counts as the reference's separate add); ``sort`` n·log₂n; the
  gathers ``out/4``; the scatters ``update/4``; every other op one FLOP
  per output element (``by_prim["elementwise"]``); views, copies and
  allocations are free.
* ``bytes`` — Σ (operand + result) bytes of each matmul and sort (× log₂n),
  2 × output + index bytes of a gather, 3 × update + index bytes of a
  scatter, the output of a concatenation or pad: an unfused upper bound on
  memory traffic, as the reference's.

The walker runs on any device: ``meta`` for the dry run (nothing is
allocated or computed), ``cuda`` for a measured step.  A hand-written
kernel is launched through its own library, past the dispatcher, so the
walker reads the launch-signature registry every kernel entry point
writes (:func:`repro_torch.check.runtime.record_launch`) and charges each
launch on the card by :data:`KERNEL_CHARGES`, the work of the function the
kernel computes (``by_prim[<kernel>]``).  On the CPU a kernel's plain
version runs in torch ops, and those are counted instead.

Collectives and repeated work come from :mod:`repro_torch.obs.cost`.  All
numbers are global: callers divide by the chip count for per-device terms.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.check import runtime
from repro_torch.obs import cost as hooks

__all__ = ["CostWalker", "trace_cost", "KERNEL_CHARGES", "attention_cost", "panel_cost",
           "csr_cost"]


def _name(func) -> str:
    return func.overloadpacket.__name__.rstrip("_")


_DOTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "vdot", "mv", "addmv"}
_FUSED_ADD = {"addmm", "baddbmm", "addbmm", "addmv"}
_SORTS = {"sort"}
_GATHERS = {"index_select", "gather", "embedding", "_embedding_bag",
            "_embedding_bag_forward_only", "embedding_bag", "index", "take",
            "take_along_dim", "_unsafe_index"}
# scatter name -> (position of the update, position of the index); -1: the output
_SCATTERS = {
    "index_add": (3, 2), "scatter_add": (3, 2), "scatter_reduce": (3, 2), "scatter": (3, 2),
    "index_reduce": (3, 2), "index_put": (2, 1), "_index_put_impl": (2, 1),
    "embedding_dense_backward": (0, 1), "_embedding_bag_backward": (0, 1),
    "_embedding_bag_dense_backward": (0, 1), "index_fill": (-1, 2), "masked_scatter": (2, 1),
}
_LAYOUT_BYTES = {"cat", "stack", "constant_pad_nd", "pad", "repeat"}
# the reference's convert/transpose/select class: FLOPs, but no by_prim entry
_UNLISTED = {"_to_copy", "where", "masked_fill"}
_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "expand_as", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "slice", "select", "as_strided", "alias",
    "detach", "clone", "contiguous", "copy", "split", "split_with_sizes", "unbind", "chunk",
    "narrow", "unfold", "diagonal", "view_as_real", "view_as_complex", "lift_fresh",
    "lift_fresh_copy", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full", "full_like",
    "new_zeros", "new_ones", "new_full", "arange", "scalar_tensor", "fill", "zero",
    "_has_compatible_shallow_copy_type", "set", "resize", "_local_scalar_dense",
    "is_same_size", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "dim",
    "size", "stride", "numel", "is_nonzero", "unsafe_split", "split_copy",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


def _numel(x) -> int:
    return sum(t.numel() for t in _tensors(x))


# ---------------------------------------------------------------------------
# kernel charges: the work of the function each hand-written kernel computes


def causal_pairs(sq: int, skv: int) -> int:
    """Valid (query, key) pairs under the bottom-right aligned causal mask
    (query i sees key j when i + Skv - Sq >= j): S(S+1)/2 where Sq = Skv."""
    off = skv - sq
    first = max(0, -off)  # the rows before it see no key
    return (first + off + 1 + skv) * (sq - first) // 2 if sq > first else 0


def attention_cost(b, hq, hkv, sq, skv, d, causal, itemsize):
    """``(flops, bytes)`` of softmax attention: 4·D FLOPs per valid (query,
    key) pair and query head (its two matmuls; a causal mask with Sq = Skv
    about halves the pairs), and Q, K, V read and O written once."""
    pairs = causal_pairs(sq, skv) if causal else sq * skv
    return 4 * b * hq * d * pairs, itemsize * (2 * b * hq * sq * d + 2 * b * hkv * skv * d)


def _attention_charge(args, static):
    q, k, _ = args
    b, hq, sq, d = q.shape
    return attention_cost(b, hq, k.shape[1], sq, k.shape[2], d, static.get("causal", True),
                          q.element_size())


def panel_cost(rows, lu, lv, itemsize, out_bytes):
    """``(compares, bytes)`` of a panel intersection: every entry of both
    panels read once and the outputs written once, one binary search of
    the ``lv``-wide panel per ``lu`` entry.  From the shapes, every entry
    counted as valid: chip_smoke.py's ``bound`` counts only the valid ones."""
    return rows * lu * max(1, math.ceil(math.log2(lv + 1))), itemsize * rows * (lu + lv) + out_bytes


def csr_cost(rows, width, row_bytes, out_bytes):
    """``(compares, bytes)`` of a CSR intersection kernel: both lists of a
    row read at most ``width`` entries each, ``row_bytes`` for the row's
    own ids and offsets, the outputs written once; one binary search of
    the longer list per entry of the shorter.  From the shapes, every list
    ``width`` long: chip_smoke.py's ``csr_bound`` reads the real lengths."""
    return (rows * width * max(1, math.ceil(math.log2(width + 1))),
            rows * (8 * width + row_bytes) + out_bytes)


def _panel_charge(kind):
    def charge(args, static):
        a, b = args
        rows, lu = a.shape
        lv = b.shape[1]
        out = 4 * rows + (4 * rows * lu if kind != "intersect_count" else 0) + \
            (4 * rows * lv if kind == "intersect_support" else 0)
        return panel_cost(rows, lu, lv, a.element_size(), out)

    return charge


def _csr_charge(kind):
    def charge(args, static):
        rows, width = args[2].shape[0], static["width"]
        if kind == "intersect_count_csr":
            row_bytes, out = 28, 0
        else:  # each output slot read and written
            row_bytes, out = (24, 8 * static["n_out"]) if kind == "intersect_per_node_csr" \
                else (28, 8 * static["n_out"])
        return csr_cost(rows, width, row_bytes, out)

    return charge


#: kernel entry point -> ``charge(tensor args, static args) -> (flops, bytes)``
KERNEL_CHARGES = {
    "flash_attention": _attention_charge,
    **{k: _panel_charge(k) for k in ("intersect_count", "intersect_per_node",
                                     "intersect_support")},
    **{k: _csr_charge(k) for k in ("intersect_count_csr", "intersect_per_node_csr",
                                   "intersect_support_csr")},
}


# ---------------------------------------------------------------------------
# the walker


def _meta_key(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _meta_key(v)) for k, v in x.items()))
    if isinstance(x, torch.Generator):
        return "gen"
    hash(x)
    return x


_FRESH: dict = {}


def _fresh_outputs(func) -> bool:
    """True when ``func`` mutates nothing and returns new tensors (no views)."""
    fresh = _FRESH.get(func)
    if fresh is None:
        schema = func._schema
        fresh = _FRESH[func] = not schema.is_mutable and all(
            r.alias_info is None for r in schema.returns)
    return fresh


def _flat_tensors(args, kwargs) -> list:
    """The tensors among an op's arguments (one level of lists)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


class CostWalker(TorchDispatchMode):
    """Counts the cost of every op run inside ``with CostWalker() as w:``.

    ``w.report()`` holds the reference's keys (``flops``, ``bytes``,
    ``by_prim``, ``bytes_by_prim``, ``warnings``) and the port's:
    ``collectives`` (the records of :func:`repro_torch.obs.cost.record_collective`),
    ``kernels`` (launches charged per kernel), ``by_region`` and, with
    ``track_memory``, ``temp_peak_bytes``: the peak bytes of the tensors
    the ops made that were alive at once.
    """

    def __init__(self, track_memory: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_prim = defaultdict(float)
        self.bytes_by_prim = defaultdict(float)
        self.collectives: list = []
        self.kernels: dict = {}
        self.by_region = defaultdict(lambda: {"flops": 0.0, "dot_flops": 0.0})
        self.track_memory = track_memory
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._mult = [1]
        self._regions: list = []
        self._memo: dict = {}

    # -- hooks the port's code calls (through repro_torch.obs.cost) --------

    def collective(self, kind, bytes_per_device, axes):
        self.collectives.append({"kind": kind, "bytes": bytes_per_device, "axes": list(axes),
                                 "count": self._mult[-1]})

    def push_repeat(self, n):
        self._mult.append(self._mult[-1] * int(n))

    def pop_repeat(self):
        self._mult.pop()

    @contextlib.contextmanager
    def in_region(self, name):
        self._regions.append(name)
        try:
            yield
        finally:
            self._regions.pop()

    def tag_backward(self, name, out, inputs):
        """Hook the autograd nodes between ``out`` and ``inputs`` so that
        the ops each runs in the backward count under ``name`` too."""
        def enter(grad_outputs):
            if self in hooks._WALKERS:
                self._regions.append(name)

        def leave(grad_inputs, grad_outputs):
            if self in hooks._WALKERS and self._regions:
                self._regions.pop()

        stops = [t.grad_fn for t in _tensors(inputs) if t.grad_fn is not None]
        todo = [t.grad_fn for t in _tensors(out) if t.grad_fn is not None]
        seen = {}  # id -> node, held so that no id is reused during the walk
        while todo:
            node = todo.pop()
            if node is None or id(node) in seen or any(node is s for s in stops) \
                    or type(node).__name__ == "AccumulateGrad":
                continue
            seen[id(node)] = node
            node.register_prehook(enter)
            node.register_hook(leave)
            todo.extend(n for n, _ in node.next_functions)

    def _launch(self, name, args, static):
        charge = KERNEL_CHARGES.get(name)
        if charge is None or not any(t.is_cuda for t in _tensors(args)):
            return  # a plain version on the CPU: its torch ops are counted
        flops, n_bytes = charge(list(args), static)
        m = self._mult[-1]
        k = self.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += m
        k["flops"] += m * flops
        k["bytes"] += m * n_bytes
        self._add(name, flops, n_bytes, name)

    # -- the mode ------------------------------------------------------------

    def __enter__(self):
        hooks._WALKERS.append(self)
        runtime.add_launch_listener(self._launch)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            runtime.remove_launch_listener(self._launch)
            hooks._WALKERS.remove(self)

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; on ``meta`` the result of an op that
        makes new tensors depends only on its inputs' shapes, so it is
        computed once per signature and then only allocated."""
        ts = _flat_tensors(args, kwargs)
        if not ts or not _fresh_outputs(func) or not all(t.is_meta for t in ts):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
        except TypeError:
            return func(*args, **kwargs)
        spec = self._memo.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                self._memo[key] = (tuple(out.shape), out.stride(), out.dtype)
            elif isinstance(out, (tuple, list)) and all(isinstance(o, torch.Tensor) for o in out):
                self._memo[key] = [(tuple(o.shape), o.stride(), o.dtype) for o in out]
            return out
        if isinstance(spec, tuple):
            return torch.empty_strided(spec[0], spec[1], dtype=spec[2], device="meta")
        return tuple(torch.empty_strided(s, st, dtype=dt, device="meta") for s, st, dt in spec)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = self._run(func, args, kwargs)
        self._charge(func, args, out)
        if self.track_memory:
            self._track(func, out)
        return out

    def _region(self):
        return self._regions[-1] if self._regions else None

    def _add(self, prim, flops, n_bytes, bytes_prim=None, listed=True):
        m = self._mult[-1]
        self.flops += m * flops
        self.bytes += m * n_bytes
        if listed and flops:
            self.by_prim[prim] += m * flops
        if bytes_prim and n_bytes:
            self.bytes_by_prim[bytes_prim] += m * n_bytes
        region = self._region()
        if region is not None:
            r = self.by_region[region]
            r["flops"] += m * flops
            if prim in ("dot_general", "ragged_dot"):
                r["dot_flops"] += m * flops

    def _charge(self, func, args, out):
        name = _name(func)
        if name in _FREE:
            return
        if name in _DOTS:
            a = args[1] if name in _FUSED_ADD else args[0]
            if name == "addbmm":
                flops = 2 * a.numel() * args[2].shape[-1]
            else:
                flops = 2 * out.numel() * a.shape[-1]
            prim = "ragged_dot" if self._region() == "ragged_dot" else "dot_general"
            n_bytes = _nbytes(args) + _nbytes(out)
            self._add(prim, flops, n_bytes, prim)
            if name in _FUSED_ADD:  # the bias add, a separate op in the reference
                self._add("elementwise", out.numel(), 0)
            return
        if name in _SORTS:
            n = max(t.numel() for t in _tensors(args))
            logn = max(1.0, math.log2(max(n, 2)))
            self._add("sort", n * logn, (_nbytes(args) + _nbytes(out)) * logn, "sort")
            return
        if name in _GATHERS:
            first = next(_tensors(out))
            idx_b = _nbytes(args[1:])
            self._add("gather", first.numel() / 4, 2 * first.numel() * first.element_size()
                      + idx_b, "gather", listed=False)
            return
        if name in _SCATTERS:
            upd_at, idx_at = _SCATTERS[name]
            upd = args[upd_at] if 0 <= upd_at < len(args) else None
            upd_b = _nbytes(upd) if isinstance(upd, torch.Tensor) else _nbytes(out)
            idx_b = _nbytes(args[idx_at]) if idx_at < len(args) else 0
            self._add("scatter", upd_b / 4, 3 * upd_b + idx_b, "scatter", listed=False)
            return
        if name in _LAYOUT_BYTES:
            self._add("layout", 0, _nbytes(out), "layout")
            return
        self._add("elementwise", _numel(out), 0, listed=name not in _UNLISTED)

    def _track(self, func, out):
        fresh = _fresh_outputs(func)
        for t in _tensors(out):
            key = t.untyped_storage()._cdata
            held = self._storages.get(key)
            if held is None:
                if not fresh:
                    continue  # a view or an in-place op on a tensor made outside
                held = self._storages[key] = [0, t.untyped_storage().nbytes()]
                self.live += held[1]
                self.peak = max(self.peak, self.live)
            held[0] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key):
        held = self._storages.get(key)
        if held is None:
            return
        held[0] -= 1
        if held[0] == 0:
            self.live -= held[1]
            del self._storages[key]

    def report(self) -> dict:
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "by_prim": dict(self.by_prim),
            "bytes_by_prim": dict(self.bytes_by_prim),
            "warnings": [],  # the reference notes uncounted while loops; eager ops have none
            "collectives": list(self.collectives),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
            "by_region": {k: dict(v) for k, v in self.by_region.items()},
            "temp_peak_bytes": self.peak if self.track_memory else None,
        }


def trace_cost(fn, *args) -> dict:
    """Run ``fn(*args)`` under a :class:`CostWalker` (``meta`` tensors run
    nothing) and return the reference's record: ``flops``, ``bytes``,
    ``by_prim``, ``bytes_by_prim``, ``warnings``."""
    with CostWalker() as w:
        fn(*args)
    rep = w.report()
    return {k: rep[k] for k in ("flops", "bytes", "by_prim", "bytes_by_prim", "warnings")}
