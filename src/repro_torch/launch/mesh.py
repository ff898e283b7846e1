"""Mesh construction for the port's entry points and the dry run.

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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The dry run's production mesh of H100s, as ``meta`` devices.

    ``(32, 8)`` ``("data", "model")``: 256 GPUs, one DGX SuperPOD scalable
    unit of 32 DGX H100 nodes, ``model`` one node's 8 GPUs on NVLink;
    ``multi_pod``: two such units, ``(2, 32, 8)`` ``("pod", "data",
    "model")``, 512 GPUs.  The chip counts are the reference's; its
    16-wide ``model`` axis would straddle two 8-GPU NVLink domains, so the
    port's ``model`` axis is 8 wide and ``data`` twice as long.  Every
    device is ``meta``: the dry run traces shapes and allocates nothing.
    """
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, "meta", dtype=object), axes)


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

