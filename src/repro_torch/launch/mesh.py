"""Mesh construction for the port's entry points.

The PyTorch counterpart of ``repro.launch.mesh``.  Functions, never
module-level constants, so importing this module never queries a device.
A mesh here is a :class:`repro_torch.distributed.Mesh` of torch devices,
driven from one process as the reference drives its ``jax`` mesh.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.mesh import Mesh

__all__ = ["make_production_mesh", "make_local_mesh", "DATA_AXES", "ALL_AXES"]

DATA_AXES = ("pod", "data")   # gradient / batch parallelism axes
ALL_AXES = ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 256- and 512-chip TPU pods: held for ROADMAP A9."""
    raise NotImplementedError(
        "make_production_mesh is not yet ported to repro_torch (ROADMAP A9: "
        "the dry run's TPU pods); use the JAX package repro for it"
    )


def _visible(device=None) -> list[torch.device]:
    """The visible devices of ``device``'s type (``None``: the cards)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_local_mesh(data: int | None = None, model: int = 1, *, device=None) -> Mesh:
    """A ``(data, model)`` mesh over the visible cards, or over the CPU with
    ``device="cpu"`` (one device).  Raises when the product exceeds the
    devices there, as the reference does."""
    devs = _visible(device)
    n = len(devs)
    if data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"requested {data}×{model} mesh on {n} devices")
    grid = np.empty(data * model, dtype=object)
    grid[:] = devs[: data * model]
    return Mesh(grid.reshape(data, model), ("data", "model"))

