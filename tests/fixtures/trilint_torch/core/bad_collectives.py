"""trilint fixture: deliberate collective-hygiene violations (C1/C2/C3), the port's mesh.

Parsed, never imported.  Lives under a fake `core/` directory so C2 applies.
"""

import torch

from repro_torch.distributed import Mesh

STRIPE_AXES = ("edges",)
MESH = Mesh(["cpu"] * 4, STRIPE_AXES)


def stripes_of(mesh):
    # C1: axis "stripe" is declared by no Mesh(...)/*AXIS* in this module.
    return mesh.shape["stripe"]


def count_fn_for(mesh, make_fn):
    # C1: an axis_names= keyword naming an undeclared axis.
    return make_fn(mesh, axis_names=("shard",))


def rank_dependent(mesh, parts):
    # C2: the stripe index used as a value — the result depends on which
    # stripe computed it.
    out = []
    for s, dev in enumerate(mesh.devices.flat):
        out.append(parts[s].to(dev) + s)
    return out


def default_axes(devices):
    # C3: a Mesh without explicit axis names.
    return Mesh(devices)


# --- compliant forms: not flagged ----------------------------------------


def merged(mesh, parts):
    acc = None
    for s, dev in enumerate(mesh.devices.flat):
        part = parts[s].to(mesh.lead)
        acc = part if acc is None else acc + part
    return acc


def edge_stripes(mesh):
    return mesh.shape["edges"]


def named_mesh(devices):
    return Mesh(devices, axis_names=("edges",))


def replicated(x):
    return torch.stack([x, x])
