"""trilint pass: decode-path narrowing discipline for the ``.tricsrz`` codec.

The port's counterpart of ``repro.check.codec``.  Varint/delta decoding
works in uint64/int64 — zigzag deltas are signed and a 10-byte varint can
carry a full 64-bit value — but the kernels consume int32 column ids.
The narrowing point is where a corrupt or adversarial payload turns into
silent id aliasing: a decoded value >= 2^31 wraps to a negative int32 and
indexes some *other* node's adjacency.  One rule:

* ``Z1-unchecked-decode-narrow`` — a function that consumes a decode-family
  producer (``decode_varints`` / ``decode_block`` / ``decode_node_range`` /
  ``_decode_rows`` / ``_unzigzag``) and narrows a value to int32 without
  calling a bound guard (``ensure_fits_int32`` / ``can_narrow_int32`` /
  ``validate_node_ids``) in the same function.  The numpy forms are the
  reference's (``.astype(int32)``, ``np.int32(...)``, an
  ``np.asarray(..., int32)`` dtype argument); the torch forms are
  ``.to(torch.int32)``, ``.type(torch.int32)``, ``.int()`` and a
  ``torch.tensor``/``torch.as_tensor`` with ``dtype=torch.int32``.
  Unlike overflow's O3 (index-scale producers, repo-wide), this rule keys
  on the codec's decode surface, where the values are attacker-controlled
  file bytes rather than self-generated indices.
"""

from __future__ import annotations

import ast

from .base import (
    INT32_NAMES,
    Finding,
    ModuleInfo,
    call_name,
    function_calls,
    is_int32_expr,
    method_narrowing,
    register_pass,
)

# Callables whose return values originate in the varint/delta byte stream.
_DECODE_PRODUCERS = {
    "decode_varints",
    "decode_block",
    "decode_node_range",
    "_decode_rows",
    "_unzigzag",
}

# Calling any of these in the same function counts as a loud bound check.
_NARROW_GUARDS = {"ensure_fits_int32", "can_narrow_int32", "validate_node_ids"}

# Constructors whose dtype argument narrows what they are given.
_CONSTRUCTORS = ("asarray", "array", "empty", "zeros_like", "tensor", "as_tensor")


def _narrowing_calls(fn: ast.AST):
    """Yield (call, description) for every int32 narrowing inside ``fn``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        # x.astype(np.int32) / x.to(torch.int32) / x.type(torch.int32) / x.int()
        how = method_narrowing(node)
        if how:
            yield node, how
            continue
        name = call_name(node)
        # np.int32(x) scalar cast
        if name in INT32_NAMES and node.args:
            yield node, "np.int32(...) cast"
            continue
        # np.asarray(x, np.int32) / torch.tensor(x, dtype=torch.int32) etc.
        if name.rsplit(".", 1)[-1] in _CONSTRUCTORS:
            for a in node.args[1:]:
                if is_int32_expr(a):
                    yield node, f"{name} with int32 dtype"
                    break
            else:
                for kw in node.keywords:
                    if kw.arg == "dtype" and is_int32_expr(kw.value):
                        yield node, f"{name} with dtype=int32"
                        break


@register_pass("codec")
def check_codec(mod: ModuleInfo) -> "list[Finding]":
    findings: "list[Finding]" = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        calls = function_calls(fn)  # includes both dotted and bare names
        if not _DECODE_PRODUCERS & calls:
            continue
        if _NARROW_GUARDS & calls:
            continue
        for call, how in _narrowing_calls(fn):
            findings.append(
                mod.finding(
                    "codec",
                    "Z1-unchecked-decode-narrow",
                    call,
                    f"`{fn.name}` narrows decoded varint/delta data via {how} "
                    "with no ensure_fits_int32/can_narrow_int32 guard in the "
                    "function; a corrupt payload wraps to a negative id and "
                    "aliases another node's adjacency",
                )
            )
    return findings
