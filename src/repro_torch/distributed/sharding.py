"""Regex-path → PartitionSpec sharding rules, and tensors held as blocks on a mesh.

The counterpart of ``repro.distributed.sharding`` (Megatron-pattern tensor
parallelism + FSDP over the data axis, the same rules and regexes), plus
what ``jax.sharding`` gives the reference:

* :class:`PartitionSpec` (``P``) — per dimension, the mesh axes it is split
  over: ``None``, an axis name, or a tuple of names (split over their
  product, the first the major);
* :class:`NamedSharding` — a spec on a :class:`~repro_torch.distributed.Mesh`;
* :class:`ShardedTensor` and :func:`device_put` — the counterpart of a
  sharded ``jax.Array`` and of ``jax.device_put(tree, shardings)``: one
  block per mesh coordinate, on that coordinate's device, replicated along
  the axes the spec leaves out; the tensor knows its global shape, spec and
  mesh and gathers to one device.

**Paths.**  The reference's rules match stacked-layer paths such as
``layers/wq`` on an (L, d, d) leaf, whose spec ``(None, f, "model")``
starts with the layer axis.  The port keeps ``layers`` as a list of
per-layer dicts, so a list stands for that stacked axis: its index is left
out of the path, the spec is taken for the leaf's rank plus one for each
list above it, and those leading (layer) entries are dropped — a per-layer
``wq`` gets ``(f, "model")``, an MoE expert weight ``(None, f, "model")``,
the router ``(f, None)``: the reference's specs without their layer axis.
Dict keys render as themselves, tuple positions as their index, NamedTuple
fields as ``.name`` (as ``jax.tree_util`` renders ``GetAttrKey``).

Optimizer moments reuse the parameters' specs (ZeRO optimizer-state
sharding; :func:`repro_torch.configs.lm_common._opt_state_specs`).

**Collectives.**  :meth:`ShardedTensor.gather` is an all-gather of the
blocks and tells the cost walker what it moves
(:func:`repro_torch.obs.cost.record_collective`).  On a mesh of
``meta`` devices (the dry run's) every block of a tensor has one shape, so
one block's work stands for the others' (:func:`repro_torch.obs.cost.stand_in`)
and :func:`device_put` copies nothing.
"""
from __future__ import annotations

import re
from typing import Sequence

import numpy as np
import torch

from repro_torch.obs.cost import record_collective, stand_in

from .mesh import Mesh

__all__ = [
    "ShardingRules",
    "make_param_shardings",
    "spec_for",
    "LM_RULES",
    "lm_rules",
    "moe_rules_patch",
    "PartitionSpec",
    "P",
    "NamedSharding",
    "ShardedTensor",
    "device_put",
    "sharded_zeros_like",
]


class PartitionSpec:
    """Per-dimension mesh axes: ``None``, an axis name or a tuple of names.

    Not a tuple, so tree walkers take it as one leaf.  Equal to another
    spec or a tuple with the same entries."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(tuple(p) if isinstance(p, list) else p for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self) -> int:
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            other = other._parts
        return isinstance(other, tuple) and self._parts == other

    def __repr__(self) -> str:
        return f"P{self._parts!r}" if len(self._parts) != 1 else f"P({self._parts[0]!r})"


P = PartitionSpec


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class NamedSharding:
    """A :class:`PartitionSpec` on a :class:`Mesh`."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        if not isinstance(mesh, Mesh):
            raise TypeError(f"NamedSharding takes a repro_torch.distributed.Mesh, got {type(mesh).__name__}")
        spec = spec if isinstance(spec, PartitionSpec) else PartitionSpec(*spec)
        used = [a for e in spec for a in _axes(e)]
        unknown = sorted(set(used) - set(mesh.axis_names))
        if unknown:
            raise ValueError(f"{spec}: axes {unknown} are not in the mesh's {mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"{spec}: a mesh axis shards more than one dimension")
        self.mesh, self.spec = mesh, spec

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"

    def _parts(self, ndim: int) -> list[tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than a rank-{ndim} tensor has dims")
        return [_axes(e) for e in self.spec] + [()] * (ndim - len(self.spec))

    def block_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        """The shape of each block; raises where a sharded dimension does
        not divide by its axes' size."""
        out = []
        for n, axes in zip(shape, self._parts(len(shape))):
            k = int(np.prod([self.mesh.shape[a] for a in axes], dtype=np.int64))
            if n % k:
                raise ValueError(f"{self.spec}: dimension {n} does not divide by "
                                 f"{'×'.join(axes)} = {k}")
            out.append(n // k)
        return tuple(out)

    def block_index(self, coord: tuple[int, ...], ndim: int) -> tuple[int, ...]:
        """Which block along each dimension mesh coordinate ``coord`` holds."""
        pos = {a: i for i, a in enumerate(self.mesh.axis_names)}
        index = []
        for axes in self._parts(ndim):
            i = 0
            for a in axes:
                i = i * self.mesh.shape[a] + coord[pos[a]]
            index.append(i)
        return tuple(index)

    def slices(self, coord: tuple[int, ...], shape: Sequence[int]) -> tuple[slice, ...]:
        """The part of a tensor of ``shape`` that ``coord``'s block holds."""
        bshape = self.block_shape(shape)
        return tuple(slice(i * b, (i + 1) * b)
                     for i, b in zip(self.block_index(coord, len(shape)), bshape))


class ShardedTensor:
    """A tensor held as blocks on a mesh: the port's sharded ``jax.Array``.

    ``blocks`` is an object array of the mesh's shape; ``blocks[coord]``
    is the part :meth:`NamedSharding.slices` names, on ``mesh.devices[coord]``.
    Blocks never share storage, so an in-place update of every block (an
    optimizer step) updates each replica once — except on a ``meta`` mesh,
    whose coordinates all hold one block with no values.
    """

    def __init__(self, blocks: np.ndarray, shape, sharding: NamedSharding):
        self.blocks, self.shape, self.sharding = blocks, torch.Size(shape), sharding
        self.dtype = blocks.flat[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def coords(self):
        return np.ndindex(*self.blocks.shape)

    @property
    def on_meta(self) -> bool:
        """True on a mesh of ``meta`` devices: one block's work stands for all."""
        return self.mesh.lead.type == "meta"

    @property
    def sharded_axes(self) -> tuple[str, ...]:
        """The mesh axes the spec splits a dimension over."""
        return tuple(a for e in self.spec for a in _axes(e))

    @property
    def block_nbytes(self) -> int:
        """The bytes of one block."""
        return int(np.prod(self.sharding.block_shape(self.shape), dtype=np.int64)) * \
            self.blocks.flat[0].element_size()

    def unique_blocks(self) -> list:
        """``(slices, block)``, one per distinct part (a replicated part once)."""
        seen = {}
        for c in self.coords():
            key = self.sharding.block_index(c, self.ndim)
            if key not in seen:
                seen[key] = (self.sharding.slices(c, self.shape), self.blocks[c])
        return list(seen.values())

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the mesh's lead by default)."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device or self.mesh.lead)
        blocks = self.unique_blocks()
        if len(blocks) > 1:
            record_collective("all-gather", self.block_nbytes, self.sharded_axes)
        for sl, blk in stand_in(blocks, self.on_meta):
            out[sl].copy_(blk)
        return out

    def add_slices_(self, full: torch.Tensor, alpha: float = 1.0) -> None:
        """Add the matching part of the whole tensor ``full`` into every block."""
        for c in stand_in(self.coords(), self.on_meta):
            blk = self.blocks[c]
            blk.add_(full[self.sharding.slices(c, self.shape)].to(blk.device), alpha=alpha)

    def numpy(self) -> np.ndarray:
        return self.gather(torch.device("cpu")).numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"spec={self.spec!r}, mesh={self.mesh.shape})")


def _place(x, sharding: NamedSharding) -> ShardedTensor:
    if isinstance(x, ShardedTensor):
        x = x.gather(sharding.mesh.lead)
    elif not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    x = x.detach()  # blocks hold values: a parameter's copy tracks no graph
    bshape = sharding.block_shape(x.shape)
    blocks = np.empty(sharding.mesh.devices.shape, dtype=object)
    if sharding.mesh.lead.type == "meta":
        _meta_blocks(blocks, bshape, x.dtype)
        return ShardedTensor(blocks, x.shape, sharding)
    for c in np.ndindex(*blocks.shape):
        blk = torch.empty(bshape, dtype=x.dtype, device=sharding.mesh.devices[c])
        blocks[c] = blk.copy_(x[sharding.slices(c, x.shape)])
    return ShardedTensor(blocks, x.shape, sharding)


def _meta_blocks(blocks: np.ndarray, shape, dtype) -> None:
    """Fill ``blocks`` with one ``meta`` block, held by every coordinate of
    a ``meta`` mesh: it has no values, and one block's work stands for
    every block's."""
    blk = torch.empty(shape, dtype=dtype, device="meta")
    for c in np.ndindex(*blocks.shape):
        blocks[c] = blk


def _walk(tree, fn, path=(), depth=0, rest=()):
    """``tree`` with each leaf replaced by ``fn(leaf, path, depth, *rest leaves)``;
    a :class:`NamedSharding` in ``rest`` covers the whole subtree below it."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _walk(tree[k], fn, path + (str(k),), depth, _sub(rest, k)) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(getattr(tree, f), fn, path + ("." + f,), depth, _sub(rest, f, True))
                            for f in tree._fields))
    if isinstance(tree, list):  # the port's stacked axis: no index in the path
        return [_walk(v, fn, path, depth + 1, _sub(rest, i)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(_walk(v, fn, path + (str(i),), depth, _sub(rest, i)) for i, v in enumerate(tree))
    return fn(tree, path, depth, *rest)


def _sub(rest, key, attr=False):
    return tuple(r if isinstance(r, NamedSharding) else (getattr(r, key) if attr else r[key])
                 for r in rest)


def device_put(tree, shardings):
    """Each leaf of ``tree`` (tensors, numpy arrays or :class:`ShardedTensor`)
    cut into its blocks by the matching :class:`NamedSharding`; a sharding
    may stand for a whole subtree, as in ``jax.device_put``."""
    return _walk(tree, lambda x, path, depth, s: _place(x, s), rest=(shardings,))


def sharded_zeros_like(x: ShardedTensor, sharding: NamedSharding | None = None) -> ShardedTensor:
    """f32 zeros of ``x``'s shape laid out by ``sharding`` (``x``'s own by
    default), each block made on its device: moments and gradient sums."""
    sharding = sharding or x.sharding
    bshape = sharding.block_shape(x.shape)
    blocks = np.empty(sharding.mesh.devices.shape, dtype=object)
    if sharding.mesh.lead.type == "meta":
        _meta_blocks(blocks, bshape, torch.float32)
        return ShardedTensor(blocks, x.shape, sharding)
    for c in np.ndindex(*blocks.shape):
        blocks[c] = torch.zeros(bshape, dtype=torch.float32, device=sharding.mesh.devices[c])
    return ShardedTensor(blocks, x.shape, sharding)


class ShardingRules:
    """Ordered (regex, PartitionSpec-builder) rules over tree paths."""

    def __init__(self, rules: Sequence[tuple[str, tuple]], fsdp_axes=("data",)):
        self.rules = [(re.compile(pat), spec) for pat, spec in rules]
        self.fsdp_axes = fsdp_axes

    def spec(self, path: str, ndim: int) -> PartitionSpec:
        for pat, spec in self.rules:
            if pat.search(path):
                spec = spec[-ndim:] if len(spec) > ndim else spec
                return P(*spec, *([None] * (ndim - len(spec))))
        return P(*([None] * ndim))


def _leaf_spec(rules: ShardingRules, leaf, path, depth) -> PartitionSpec:
    full = rules.spec("/".join(path), getattr(leaf, "ndim", 0) + depth)
    if any(e is not None for e in full[:depth]):
        raise ValueError(f"{'/'.join(path)}: {full} shards the stacked layer axis, which "
                         "the port keeps as a list")
    return P(*full[depth:])


def spec_for(rules: ShardingRules, tree):
    """Tree of PartitionSpecs matching ``tree``'s structure."""
    return _walk(tree, lambda leaf, path, depth: _leaf_spec(rules, leaf, path, depth))


def make_param_shardings(mesh: Mesh, rules: ShardingRules, tree):
    return _walk(spec_for(rules, tree), lambda s, path, depth: NamedSharding(mesh, s))


def lm_rules(fsdp: tuple[str, ...] = ("data",), tp_only: bool = False) -> ShardingRules:
    """Sharding rules for the transformer parameter tree.

    Layer params carry a leading stacked-layer dim in the reference (from
    its scan), hence the leading ``None`` in the 3-entry specs; the engine
    right-aligns specs shorter than the array rank.

    ``tp_only``: drop the FSDP axis from the weights — for models whose
    fp32 master+moments fit in HBM/TP_degree, per-microbatch weight
    all-gathers are pure overhead; the only DP collective left is the
    gradient all-reduce.
    """
    f = None if tp_only else (fsdp if len(fsdp) > 1 else fsdp[0])
    return ShardingRules(
        [
            # attention — column parallel
            (r"layers/w[qkv]$", (None, f, "model")),
            # attention output — row parallel
            (r"layers/wo$", (None, "model", f)),
            # dense FFN
            (r"layers/w_(gate|up)$", (None, f, "model")),
            (r"layers/w_down$", (None, "model", f)),
            # router (L, d, E): E is tiny (#experts) — never sharded
            (r"layers/router$", (None, f)),
            # vocab parallel
            (r"^embed$", ("model", f)),
            (r"^lm_head$", (f, "model")),
            # everything else (norms, biases) replicated
        ],
        fsdp_axes=fsdp,
    )


LM_RULES = lm_rules()


def moe_rules_patch(
    rules: ShardingRules, fsdp: tuple[str, ...] = ("data",), tp_only: bool = False
) -> ShardingRules:
    """Extra specs for MoE expert weights (L, E, d, ff): expert-TP — the
    per-expert ff dim shards over model, d over FSDP."""
    f = None if tp_only else (fsdp if len(fsdp) > 1 else fsdp[0])
    extra = [
        (r"layers/w_(gate|up)$", (None, None, f, "model")),
        (r"layers/w_down$", (None, None, "model", f)),
    ]
    merged = [(p.pattern, s) for p, s in rules.rules]
    return ShardingRules(extra + merged, fsdp_axes=fsdp)
