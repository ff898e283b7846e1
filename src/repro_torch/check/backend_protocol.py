"""trilint pass: backend-protocol conformance.

The port's copy of ``repro.check.backend_protocol``; it applies as it
stands to ``core/engine.py``'s ``KernelBackend``, the backends'
``capabilities`` and ``register_backend``.

The registry contract: a ``register_backend`` target either implements
the full ``KernelBackend`` surface, or the gap is *declared* in its
``capabilities`` frozenset — that declaration is the capability-gap table
``resolve_backend`` consults to produce a loud ``fallback_reason``.  A
backend that implements less than it declares (or declares nothing) can
reintroduce the silent per_node-fallback bug.

* ``B1-capability-unimplemented`` — capability declared in
  ``capabilities`` but the matching method is missing or still the
  protocol stub (``raise NotImplementedError``) across the in-module
  inheritance chain.
* ``B2-no-capability-table`` — registered backend with no resolvable
  ``capabilities`` declaration; the fallback machinery cannot see its
  gaps.
* ``B3-undeclared-capability`` — method implemented but capability not
  declared: the engine will route around a backend that actually works.
* ``B4-missing-plan`` — registered backend with no ``plan`` anywhere in
  its chain.
"""

from __future__ import annotations

import ast
from typing import Optional

from .base import Finding, ModuleInfo, call_name, register_pass

CAPABILITY_METHODS = {
    "count": "count_chunk",
    "per_node": "per_node_chunk",
    "support": "support_chunk",
}

PROTOCOL_ROOT = "KernelBackend"


def _is_stub(fn: ast.AST) -> bool:
    """Body is (docstring +) a bare ``raise NotImplementedError``."""
    body = list(fn.body)
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
        body = body[1:]
    if len(body) != 1 or not isinstance(body[0], ast.Raise):
        return False
    exc = body[0].exc
    target = exc.func if isinstance(exc, ast.Call) else exc
    return isinstance(target, ast.Name) and target.id == "NotImplementedError"


def _string_elts(node: ast.AST) -> Optional["set[str]"]:
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        out = set()
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.add(el.value)
            else:
                return None
        return out
    return None


def _resolve_capabilities(
    value: ast.AST, module_consts: "dict[str, ast.AST]"
) -> Optional["set[str]"]:
    """Resolve a ``capabilities = ...`` RHS to a set of strings, or None."""
    node = value
    if isinstance(node, ast.Call) and call_name(node).rsplit(".", 1)[-1] == "frozenset":
        if not node.args:
            return set()
        node = node.args[0]
    if isinstance(node, ast.Name) and node.id in module_consts:
        return _resolve_capabilities(module_consts[node.id], {})
    lits = _string_elts(node)
    if lits is not None:
        return lits
    if isinstance(node, ast.Constant) and node.value is None:
        return None
    return None


def _class_map(tree: ast.AST) -> "dict[str, ast.ClassDef]":
    return {n.name: n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)}


def _module_consts(tree: ast.AST) -> "dict[str, ast.AST]":
    consts: "dict[str, ast.AST]" = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name):
                consts[tgt.id] = node.value
    return consts


def _chain(cls: ast.ClassDef, classes: "dict[str, ast.ClassDef]") -> "list[ast.ClassDef]":
    """The class plus its in-module base chain, derived-first."""
    chain, seen, frontier = [], set(), [cls]
    while frontier:
        cur = frontier.pop(0)
        if cur.name in seen:
            continue
        seen.add(cur.name)
        chain.append(cur)
        for base in cur.bases:
            name = base.id if isinstance(base, ast.Name) else None
            if name and name in classes:
                frontier.append(classes[name])
    return chain


def _registered_class_names(tree: ast.AST) -> "set[str]":
    """Class names reachable from ``register_backend(name, factory)`` calls."""
    out: "set[str]" = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if call_name(node).rsplit(".", 1)[-1] != "register_backend":
            continue
        if len(node.args) < 2:
            continue
        factory = node.args[1]
        # register_backend("wedge", WedgeBackend)
        if isinstance(factory, ast.Name):
            out.add(factory.id)
        # register_backend("wedge", lambda **kw: WedgeBackend(**kw))
        elif isinstance(factory, ast.Lambda):
            for sub in ast.walk(factory.body):
                if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name):
                    out.add(sub.func.id)
    return out


@register_pass("backend_protocol")
def check_backend_protocol(mod: ModuleInfo) -> "list[Finding]":
    findings: "list[Finding]" = []
    tree = mod.tree
    classes = _class_map(tree)
    consts = _module_consts(tree)

    registered = _registered_class_names(tree)
    # Also audit unregistered subclasses of the protocol root defined here:
    # they are one register_backend call away from the dispatch path.
    candidates = set(registered)
    for name, cls in classes.items():
        if any(isinstance(b, ast.Name) and b.id == PROTOCOL_ROOT for b in cls.bases):
            candidates.add(name)

    for name in sorted(candidates):
        cls = classes.get(name)
        if cls is None or name == PROTOCOL_ROOT:
            continue

        chain = _chain(cls, classes)
        # Effective method table: derived-most definition wins.
        methods: "dict[str, ast.AST]" = {}
        caps: Optional["set[str]"] = None
        caps_node: Optional[ast.AST] = None
        for c in chain:
            for item in c.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    methods.setdefault(item.name, item)
                elif isinstance(item, ast.Assign):
                    for tgt in item.targets:
                        if isinstance(tgt, ast.Name) and tgt.id == "capabilities" and caps_node is None:
                            caps_node = item.value
                elif isinstance(item, ast.AnnAssign):
                    if (
                        isinstance(item.target, ast.Name)
                        and item.target.id == "capabilities"
                        and item.value is not None
                        and caps_node is None
                    ):
                        caps_node = item.value
        if caps_node is not None:
            caps = _resolve_capabilities(caps_node, consts)

        implemented = {
            m for m, fn in methods.items() if not _is_stub(fn)
        }

        if caps is None:
            findings.append(
                mod.finding(
                    "backend_protocol",
                    "B2-no-capability-table",
                    cls,
                    f"backend `{name}` has no resolvable `capabilities` frozenset; "
                    "resolve_backend cannot report its gaps loudly",
                )
            )
            caps = set()

        if "plan" not in implemented:
            findings.append(
                mod.finding(
                    "backend_protocol",
                    "B4-missing-plan",
                    cls,
                    f"backend `{name}` never implements `plan`",
                )
            )

        for cap, method in CAPABILITY_METHODS.items():
            if cap in caps and method not in implemented:
                findings.append(
                    mod.finding(
                        "backend_protocol",
                        "B1-capability-unimplemented",
                        cls,
                        f"backend `{name}` declares capability '{cap}' but "
                        f"`{method}` is missing or still the protocol stub",
                    )
                )
            if cap not in caps and method in implemented:
                findings.append(
                    mod.finding(
                        "backend_protocol",
                        "B3-undeclared-capability",
                        cls,
                        f"backend `{name}` implements `{method}` but does not "
                        f"declare capability '{cap}'; the engine will fall back "
                        "around a working backend",
                    )
                )
    return findings
