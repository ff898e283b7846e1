"""trilint pass: stats lifecycle at workload entry points.

The port's copy of ``repro.check.stats_lifecycle`` (``last_stats``,
``last_update_stats``, ...).  The bug class: ``EngineStats``/
``last_stats``-style fields written in one code path leak into the next
call's observation if an entry point forgets to clear them
(``edge_support`` once reported the *previous* workload's
``fallback_reason``).  The invariant: every public entry point that can
(transitively, through private helpers) write a ``last_*stats``
attribute must reset that attribute to ``None`` in its own body first.

* ``S1-stale-stats`` — public method reaches a ``self.last_*stats = ...``
  writer through private-method calls but never executes
  ``self.<attr> = None`` itself.

A public method that only reaches writers through *other public methods*
is compliant (the callee performs the reset).  ``__init__``/dunders and
``@property`` getters are exempt.
"""

from __future__ import annotations

import ast
import re

from .base import Finding, ModuleInfo, dotted_name, register_pass

_STAT_ATTR = re.compile(r"^last_\w*stats$")


def _self_attr_assigns(fn: ast.AST) -> "list[tuple[str, bool]]":
    """(attr, is_none_clear) for every ``self.<attr> = ...`` in the method."""
    out = []
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        for tgt in targets:
            if (
                isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"
                and _STAT_ATTR.match(tgt.attr)
            ):
                is_none = isinstance(value, ast.Constant) and value.value is None
                out.append((tgt.attr, is_none))
    return out


def _self_calls(fn: ast.AST) -> "set[str]":
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            name = dotted_name(node.func)
            if name.startswith("self."):
                out.add(name.split(".", 1)[1].split(".", 1)[0])
    return out


def _is_property(fn: ast.AST) -> bool:
    for deco in fn.decorator_list:
        name = dotted_name(deco if not isinstance(deco, ast.Call) else deco.func)
        if name in ("property", "cached_property", "functools.cached_property"):
            return True
    return False


@register_pass("stats_lifecycle")
def check_stats_lifecycle(mod: ModuleInfo) -> "list[Finding]":
    findings: "list[Finding]" = []

    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        methods = {
            item.name: item
            for item in cls.body
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
        }

        writes: "dict[str, set]" = {}
        clears: "dict[str, set]" = {}
        for name, fn in methods.items():
            w, c = set(), set()
            for attr, is_none in _self_attr_assigns(fn):
                (c if is_none else w).add(attr)
            writes[name] = w
            clears[name] = c

        if not any(writes.values()):
            continue  # class has no stats lifecycle

        # Fixpoint: attrs each method can write, propagating ONLY through
        # private callees (public callees reset on their own entry).
        reach = {name: set(w) for name, w in writes.items()}
        changed = True
        while changed:
            changed = False
            for name, fn in methods.items():
                for callee in _self_calls(fn):
                    if callee in methods and callee.startswith("_"):
                        extra = reach[callee] - reach[name]
                        if extra:
                            reach[name] |= extra
                            changed = True

        for name, fn in methods.items():
            if name.startswith("_") or _is_property(fn):
                continue  # private helpers and read-only views are exempt
            stale = reach[name] - clears[name]
            if stale:
                attrs = ", ".join(sorted(stale))
                findings.append(
                    mod.finding(
                        "stats_lifecycle",
                        "S1-stale-stats",
                        fn,
                        f"public entry point `{cls.name}.{name}` can write "
                        f"`{attrs}` via private helpers but never clears "
                        "it/them to None on entry; a failed or divergent path "
                        "leaves the previous workload's stats observable",
                    )
                )
    return findings
