"""A mesh of torch devices: the port's counterpart of ``jax.sharding.Mesh``.

``src/repro/`` has no file of its own for this: the reference builds its
meshes with ``jax.sharding.Mesh`` and drives every stripe of the §III-E
scheme from one process through ``shard_map``.  The port keeps that
single-controller model: one process holds a :class:`Mesh`, launches each
stripe's work on the stripe's device, and lands every collective (the
reference's ``psum`` / ``all_gather``) on the mesh's lead device.

A mesh may name one device several times.  On one card, or on the CPU in
the tests, that stands in for the reference's simulated devices
(``--xla_force_host_platform_device_count``): each stripe still runs its
own launches, one after another on the shared device.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device

__all__ = ["Mesh", "mesh_device"]


class Mesh:
    """An n-d array of ``torch.device`` with one name per axis.

    ``devices`` is a (nested) sequence of devices or device strings; a bare
    ``cuda`` becomes the current card, as in :func:`repro_torch._device.resolve_device`.
    Every device must be of one type.  The stripes of a workload are the
    flattened devices, so ``int(np.prod(mesh.devices.shape))`` counts them
    as it does for the reference's mesh.
    """

    def __init__(self, devices, axis_names: Sequence[str] = ("edges",)):
        raw = np.array(devices, dtype=object)
        if raw.size == 0:
            raise ValueError("a mesh needs at least one device")
        flat = [resolve_device(d) for d in raw.reshape(-1)]
        types = {d.type for d in flat}
        if len(types) > 1:
            raise ValueError(f"a mesh holds devices of one type, got {sorted(types)}")
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(raw.shape)
        self.axis_names = tuple(str(a) for a in axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(
                f"{len(self.axis_names)} axis name(s) for a {self.devices.ndim}-d device array"
            )
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"axis names repeat: {self.axis_names}")

    @property
    def size(self) -> int:
        """Number of stripes (devices, counted with repeats)."""
        return int(self.devices.size)

    @property
    def shape(self) -> dict[str, int]:
        """``{axis name: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def lead(self) -> torch.device:
        """The first device: where the collectives land."""
        return self.devices.flat[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each device once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices.flat))

    def replicate(self, tensor: torch.Tensor) -> dict[torch.device, torch.Tensor]:
        """One copy of ``tensor`` on every distinct device (none where it lies)."""
        return {d: tensor.to(d) for d in self.distinct}

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices.flat)
        return f"Mesh([{devs}], shape={self.shape})"


def mesh_device(mesh: Mesh | None, device=None) -> torch.device:
    """The device an entry point runs on, given its ``mesh=`` and ``device=``.

    Without a mesh this is :func:`resolve_device` (``None``: the card).
    With one it is the mesh's lead device; a ``device`` that names another
    one raises.
    """
    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a repro_torch.distributed.Mesh, got {type(mesh).__name__}")
    if device is not None and resolve_device(device) != mesh.lead:
        raise ValueError(f"device={device} but the mesh leads on {mesh.lead}")
    return mesh.lead
