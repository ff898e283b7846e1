"""Distributed runtime of the port: the device mesh, wire compression,
stripe skew, and (held for ROADMAP A7b) the LM sharding rules.

The reference's names are all exported; those of the LM train step
(``ShardingRules``, ``make_param_shardings``, ``spec_for``, ``LM_RULES``,
``compressed_psum``, ``make_error_feedback_state``, ``compress_grads``)
raise when used.  :class:`Mesh` is the port's counterpart of
``jax.sharding.Mesh``.
"""
from .sharding import ShardingRules, make_param_shardings, LM_RULES, spec_for
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
    "StragglerMonitor",
    "StripeSkewReport",
    "skew_disagreement_note",
    "stripe_skew_report",
]
