"""Distributed runtime of the port: the device mesh, the LM sharding rules,
wire compression and stripe skew.

The reference's names are all exported.  :class:`Mesh`, :class:`NamedSharding`,
:class:`PartitionSpec` (``P``) and :func:`device_put` are the port's
counterparts of ``jax.sharding`` and ``jax.device_put``; a
:class:`ShardedTensor` is a tensor held as blocks on a mesh.
"""
from .sharding import (
    ShardingRules,
    make_param_shardings,
    LM_RULES,
    spec_for,
    PartitionSpec,
    P,
    NamedSharding,
    ShardedTensor,
    device_put,
)
from .compression import (
    INT32_MAX,
    compressed_psum,
    make_error_feedback_state,
    compress_grads,
    zigzag_encode,
    zigzag_decode,
    can_narrow_int32,
    ensure_fits_int32,
    compressed_all_gather_int32,
)
from .mesh import Mesh, mesh_device
from repro_torch.obs.cost import record_collective
from .straggler import (
    StragglerMonitor,
    StripeSkewReport,
    skew_disagreement_note,
    stripe_skew_report,
)

__all__ = [
    "ShardingRules",
    "make_param_shardings",
    "spec_for",
    "LM_RULES",
    "PartitionSpec",
    "P",
    "NamedSharding",
    "ShardedTensor",
    "device_put",
    "compressed_psum",
    "make_error_feedback_state",
    "compress_grads",
    "zigzag_encode",
    "zigzag_decode",
    "can_narrow_int32",
    "ensure_fits_int32",
    "compressed_all_gather_int32",
    "INT32_MAX",
    "Mesh",
    "mesh_device",
    "record_collective",
    "StragglerMonitor",
    "StripeSkewReport",
    "skew_disagreement_note",
    "stripe_skew_report",
]
