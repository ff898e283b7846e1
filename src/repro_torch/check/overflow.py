"""trilint pass: overflow discipline on counting paths, restated for torch.

The engine's contract (README "Invariants") is: device kernels accumulate in
int32 (fast on the card, enough headroom per bounded chunk), and every fold
widens explicitly to int64/uint64 before totals are formed — the paper's
headline graph has 3.8B triangles, ~2x past int32.

torch differs from ``jnp`` here: ``torch.sum``, ``.sum()`` and
``torch.cumsum`` of an int32 tensor already accumulate in int64 unless a
``dtype=`` says otherwise, so the reference's "reduction without dtype="
rule would only raise false positives on tensors.  The torch hazard is the
opposite one, an *explicit* int32 accumulation.  Three rules:

* ``O1-sum-dtype`` — on a counting path, an explicit int32 accumulation:
  ``sum``/``cumsum`` with ``dtype=torch.int32``, or ``index_add_`` /
  ``scatter_add_`` / ``index_put_(..., accumulate=True)`` / the port's
  drop-mode scatter ``_add_in_range`` into a tensor made int32 in the same
  function.  Only the chunk partials of the device-accumulator contract
  may do this (each such site carries an inline ``ok`` saying why).  The
  reference's numpy form stays for host code: ``np.sum`` without
  ``dtype=``.
* ``O2-host-fold`` — ``int(...)`` or ``.item()`` of an int32 accumulation
  (as O1), or ``int(....sum())`` whose reduction neither passes a wide
  ``dtype=`` nor widens first (the reference's numpy form).
* ``O3-narrow`` — ``.to(torch.int32)`` / ``.int()`` / ``.type(torch.int32)``
  / ``.astype(int32)`` of a value from ``nonzero`` / ``searchsorted`` /
  ``cumsum`` / ``argsort`` / ``bincount`` (one level of local names
  substituted), or a ``searchsorted(..., out_int32=True)``, with no bound
  guard (``ensure_fits_int32`` / ``can_narrow_int32`` /
  ``validate_node_ids``) in an enclosing function.  Wraps silently at
  m >= 2^31.
"""

from __future__ import annotations

import ast

from .base import (
    Finding,
    ModuleInfo,
    build_parent_map,
    call_name,
    dotted_name,
    function_calls,
    has_keyword,
    int32_dtype_keyword,
    is_int32_expr,
    method_narrowing,
    register_pass,
)

# Modules on the triangle-counting data path, where integer reductions are
# edge/wedge/triangle-scale and must be dtype-disciplined.  Float kernels
# (flash_attention etc.) are out of scope for O1/O2; O3 applies repo-wide.
COUNTING_PREFIXES = ("core/", "analytics/", "distributed/", "kernels/triangle_count/")

# The reference's host reductions covered by O1 (numpy keeps int32 sums
# int32 only where the platform integer is 32-bit; the rule stays).
_NP_SUM_CALLS = {"np.sum", "numpy.sum"}

# Reductions whose dtype= picks the accumulator.
_REDUCTIONS = {"sum", "cumsum"}

# In-place scatters that add into their receiver, and the port's own
# drop-mode scatter helper (its first argument is the target).
_SCATTER_ADDS = {"index_add_", "scatter_add_"}
_SCATTER_HELPERS = {"_add_in_range"}

# Producers whose outputs are index/offset-scale (can exceed int32 once the
# array they index has >= 2^31 entries).
_INDEX_PRODUCERS = {"nonzero", "searchsorted", "cumsum", "argsort", "flatnonzero", "bincount"}

# Calling any of these in an enclosing scope counts as a loud bound check.
_NARROW_GUARDS = {"ensure_fits_int32", "can_narrow_int32", "validate_node_ids"}

_WIDE_NAMES = {
    "np.int64", "numpy.int64", "np.uint64", "numpy.uint64",
    "torch.int64", "torch.long", "torch.uint64",
}


def _on_counting_path(rel: str) -> bool:
    return rel.startswith(COUNTING_PREFIXES)


def _last(call: ast.Call) -> str:
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    return func.id if isinstance(func, ast.Name) else ""


def _int32_reduction(node: ast.AST) -> bool:
    """``sum``/``cumsum`` with ``dtype=`` an int32 type."""
    return (
        isinstance(node, ast.Call)
        and _last(node) in _REDUCTIONS
        and int32_dtype_keyword(node)
    )


def _is_wide(node: ast.AST) -> bool:
    if dotted_name(node) in _WIDE_NAMES:
        return True
    return isinstance(node, ast.Constant) and node.value in ("int64", "uint64")


def _widened(node: ast.AST) -> bool:
    """True if the subtree already widens: a wide ``dtype=``, or
    ``.astype``/``.to`` to int64/uint64."""
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        for kw in sub.keywords:
            if kw.arg == "dtype" and not is_int32_expr(kw.value):
                return True
        if isinstance(sub.func, ast.Attribute) and sub.func.attr in ("astype", "to"):
            if any(_is_wide(arg) for arg in sub.args):
                return True
    return False


def _contains_sum(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            if call_name(sub) in _NP_SUM_CALLS or _last(sub) == "sum":
                return True
    return False


def _makes_int32(value: ast.AST) -> bool:
    """An expression that yields an int32 tensor: a constructor with
    ``dtype=`` int32, or an int32 narrowing."""
    return isinstance(value, ast.Call) and (
        int32_dtype_keyword(value) or bool(method_narrowing(value))
    )


def _int32_target(node: ast.AST, assigns: "dict[str, ast.AST]") -> bool:
    if _makes_int32(node):
        return True
    return isinstance(node, ast.Name) and node.id in assigns and _makes_int32(assigns[node.id])


def _scatter_into_int32(call: ast.Call, assigns: "dict[str, ast.AST]") -> bool:
    last = _last(call)
    if last in _SCATTER_ADDS and isinstance(call.func, ast.Attribute):
        return _int32_target(call.func.value, assigns)
    if last == "index_put_" and isinstance(call.func, ast.Attribute):
        accumulate = any(
            kw.arg == "accumulate" and isinstance(kw.value, ast.Constant) and kw.value.value
            for kw in call.keywords
        )
        return accumulate and _int32_target(call.func.value, assigns)
    if last in _SCATTER_HELPERS and call.args:
        return _int32_target(call.args[0], assigns)
    return False


def _has_producer(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and _last(sub) in _INDEX_PRODUCERS:
            return True
    return False


def _produces_index_scale(node: ast.AST, assigns: "dict[str, ast.AST]") -> bool:
    """Does this subtree come from an index-scale producer, with one level
    of substitution for every local name in it?"""
    if _has_producer(node):
        return True
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in assigns and _has_producer(assigns[sub.id]):
            return True
    return False


def _collect_assigns(scope: ast.AST) -> "dict[str, ast.AST]":
    """Map simple ``name = expr`` assignments in a scope (last one wins)."""
    assigns: "dict[str, ast.AST]" = {}
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                assigns[tgt.id] = node.value
    return assigns


@register_pass("overflow")
def check_overflow(mod: ModuleInfo) -> "list[Finding]":
    findings: "list[Finding]" = []
    tree = mod.tree
    parents = build_parent_map(tree)
    counting = _on_counting_path(mod.rel)
    scope_assigns: "dict[ast.AST, dict[str, ast.AST]]" = {}

    def fn_stack(node: ast.AST) -> "list[ast.AST]":
        stack = []
        cur = node
        while cur in parents:
            cur = parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                stack.append(cur)
        return stack

    def assigns_of(node: ast.AST) -> "dict[str, ast.AST]":
        stack = fn_stack(node)
        scope = stack[0] if stack else tree
        if scope not in scope_assigns:
            scope_assigns[scope] = _collect_assigns(scope)
        return scope_assigns[scope]

    def folded(node: ast.AST) -> bool:
        """Is this reduction the operand of ``int()``/``float()``/``.item()``
        (O2 reports it more precisely)?"""
        parent = parents.get(node)
        while parent is not None and isinstance(parent, (ast.Subscript, ast.Attribute)):
            if isinstance(parent, ast.Attribute) and parent.attr == "item":
                return True
            parent = parents.get(parent)
        return isinstance(parent, ast.Call) and dotted_name(parent.func) in ("int", "float")

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue

        # --- O1: int32 accumulations (torch), dtype-less np.sum (host) ----
        if counting:
            what = ""
            if _int32_reduction(node):
                what = f"`{_last(node)}` with dtype=int32 accumulates in int32"
            elif call_name(node) in _NP_SUM_CALLS and not has_keyword(node, "dtype"):
                what = f"`{call_name(node)}` reduction without explicit dtype="
            elif _scatter_into_int32(node, assigns_of(node)):
                what = f"`{_last(node)}` adds into an int32 tensor"
            if what and not folded(node) and not (
                call_name(node) in _NP_SUM_CALLS and _widened(node)
            ):
                findings.append(
                    mod.finding(
                        "overflow",
                        "O1-sum-dtype",
                        node,
                        f"{what} on a counting path; only a chunk partial of the "
                        "int32 device-accumulator contract may, and its fold must widen",
                    )
                )

        # --- O2: host folds through int() / .item() ------------------------
        if counting and dotted_name(node.func) == "int" and len(node.args) == 1:
            arg = node.args[0]
            if _contains_sum(arg) and not _widened(arg):
                findings.append(
                    mod.finding(
                        "overflow",
                        "O2-host-fold",
                        node,
                        "host fold `int(....sum())` without a wide dtype= or "
                        "astype/to widening; an int32 accumulator wraps before "
                        "int() sees it",
                    )
                )
        if (
            counting
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "item"
            and any(_int32_reduction(sub) for sub in ast.walk(node.func.value))
        ):
            findings.append(
                mod.finding(
                    "overflow",
                    "O2-host-fold",
                    node,
                    "host fold `.item()` of an int32 accumulation; the sum wraps "
                    "on the device before the host sees it",
                )
            )

        # --- O3: unguarded narrowing to int32 -------------------------------
        how = method_narrowing(node)
        out_int32 = _last(node) == "searchsorted" and any(
            kw.arg == "out_int32" and isinstance(kw.value, ast.Constant) and kw.value.value
            for kw in node.keywords
        )
        if how or out_int32:
            stack = fn_stack(node)
            guarded = any(_NARROW_GUARDS & function_calls(fn) for fn in stack)
            if not stack:
                # module level: look at the whole module for a guard call
                guarded = bool(_NARROW_GUARDS & function_calls(tree))
            if guarded:
                continue
            if out_int32 or _produces_index_scale(node.func.value, assigns_of(node)):
                how = how or "searchsorted(out_int32=True)"
                findings.append(
                    mod.finding(
                        "overflow",
                        "O3-narrow",
                        node,
                        f"index-scale value narrowed with {how} and no "
                        "ensure_fits_int32/can_narrow_int32 guard in scope; "
                        "wraps silently at m >= 2^31",
                    )
                )

    return findings
