"""trilint pass: collective hygiene under the single-controller mesh.

The port's counterpart of ``repro.check.collectives``.  The port has no
``psum``/``all_gather``/``shard_map``: one process holds a
:class:`repro_torch.distributed.Mesh` (``distributed/mesh.py``: an array
of torch devices with one name per axis, ``.shape`` a ``{name: size}``
dict, ``.lead`` where every merge lands), launches each stripe on its
device, and merges the stripes' partials on ``mesh.lead``
(``core/distributed.py:striped_workload_fn``,
``distributed/compression.py:compressed_all_gather_int32``).  The three
conventions, restated for that mesh:

* ``C1-axis-undeclared`` — a string-literal axis name used on a mesh
  (``mesh.shape["x"]``, or an ``axis_names=`` keyword of a call that does
  not build a mesh) that no ``Mesh(...)``/``make_mesh(...)`` call or
  ``*AXIS*`` constant in the module declares.
* ``C2-stripe-index-in-core`` — in a ``core/`` counting module, the index
  of a loop over a mesh's devices (``for s, dev in
  enumerate(mesh.devices.flat)``) used as a value rather than to select
  the stripe's own data (a subscript), or the reference's ``axis_index``.
  Striped results must not depend on which stripe computed them: each
  stripe's partial merges on ``mesh.lead`` by position, reconstructed
  from the striping (the round-robin inverse), never from the loop index.
* ``C3-mesh-axis-names`` — a ``Mesh(...)`` built without explicit axis
  names (a second positional argument or ``axis_names=``): the default
  hides which axis a stripe count is read from.
"""

from __future__ import annotations

import ast

from .base import Finding, ModuleInfo, call_name, dotted_name, has_keyword, register_pass

# Calls whose string-constant arguments declare axis names.
_DECLARING_CALLS = {"Mesh", "make_mesh"}


def _strings(node: ast.AST) -> "list[str]":
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        return [el.value for el in node.elts
                if isinstance(el, ast.Constant) and isinstance(el.value, str)]
    return []


def _declared_axes(tree: ast.AST) -> "set[str]":
    axes: "set[str]" = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            if call_name(node).rsplit(".", 1)[-1] in _DECLARING_CALLS:
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                        axes.add(sub.value)
        elif isinstance(node, ast.Assign):
            # module constants like STRIPE_AXIS = "stripe", DATA_AXES = ("pod", "data")
            for tgt in node.targets:
                name = tgt.id.upper() if isinstance(tgt, ast.Name) else ""
                if "AXIS" in name or "AXES" in name:
                    axes.update(_strings(node.value))
    return axes


def _axis_uses(node: ast.AST) -> "list[tuple[ast.AST, str, str]]":
    """(node, axis, how) for each literal axis name this node uses on a mesh."""
    out = []
    if (
        isinstance(node, ast.Subscript)
        and isinstance(node.value, ast.Attribute)
        and node.value.attr == "shape"
        and "mesh" in dotted_name(node.value.value).lower()
    ):
        for axis in _strings(node.slice):
            out.append((node, axis, f"{dotted_name(node.value)}[...]"))
    elif isinstance(node, ast.Call) and call_name(node).rsplit(".", 1)[-1] not in _DECLARING_CALLS:
        for kw in node.keywords:
            if kw.arg == "axis_names":
                for axis in _strings(kw.value):
                    out.append((node, axis, f"axis_names= of `{call_name(node)}`"))
    return out


def _stripe_loops(tree: ast.AST):
    """Yield (loop, index name) for ``for s, dev in enumerate(<x>.devices...)``."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.For) and isinstance(node.iter, ast.Call)):
            continue
        if call_name(node.iter) != "enumerate" or not node.iter.args:
            continue
        if ".devices" not in "." + dotted_name(node.iter.args[0]):
            continue
        tgt = node.target
        if isinstance(tgt, ast.Tuple) and tgt.elts and isinstance(tgt.elts[0], ast.Name):
            yield node, tgt.elts[0].id


def _value_uses(loop: ast.For, index: str) -> "list[ast.Name]":
    """Loads of ``index`` in the loop body that are not a subscript's index."""
    parents = {}
    for stmt in loop.body:
        for node in ast.walk(stmt):
            for child in ast.iter_child_nodes(node):
                parents[child] = node
    uses = []
    for stmt in loop.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Name) and node.id == index and isinstance(node.ctx, ast.Load):
                parent = parents.get(node)
                if isinstance(parent, ast.Subscript) and parent.slice is node:
                    continue
                uses.append(node)
    return uses


@register_pass("collectives")
def check_collectives(mod: ModuleInfo) -> "list[Finding]":
    findings: "list[Finding]" = []
    tree = mod.tree
    declared = _declared_axes(tree)
    in_core = mod.rel.startswith("core/")

    for node in ast.walk(tree):
        for use, axis, how in _axis_uses(node):
            if axis not in declared:
                findings.append(
                    mod.finding(
                        "collectives",
                        "C1-axis-undeclared",
                        use,
                        f"{how} names axis '{axis}' but no Mesh(...)/*AXIS* "
                        "declaration in this module declares it",
                    )
                )
        if not isinstance(node, ast.Call):
            continue
        short = call_name(node).rsplit(".", 1)[-1]
        if short == "axis_index" and in_core:
            findings.append(
                mod.finding(
                    "collectives",
                    "C2-stripe-index-in-core",
                    node,
                    "axis_index in a core counting module: striped results must "
                    "not depend on the stripe that computed them",
                )
            )
        if short == "Mesh" and len(node.args) < 2 and not has_keyword(node, "axis_names"):
            findings.append(
                mod.finding(
                    "collectives",
                    "C3-mesh-axis-names",
                    node,
                    "Mesh(...) without explicit axis names; the stripe axis must "
                    "be visible where the mesh is built",
                )
            )

    if in_core:
        for loop, index in _stripe_loops(tree):
            for use in _value_uses(loop, index):
                findings.append(
                    mod.finding(
                        "collectives",
                        "C2-stripe-index-in-core",
                        use,
                        f"stripe index `{index}` of a loop over the mesh's devices "
                        "used as a value in a core counting module: a striped "
                        "result must not depend on the stripe that computed it "
                        "(use it only to select the stripe's own data)",
                    )
                )
    return findings
