"""trilint core: finding model, module loading, suppression, allowlists.

The port's copy of ``repro.check.base``.  trilint is a repo-specific
static-analysis suite enforcing the engine's correctness invariants (see
README "Invariants"), here restated for the port's torch idioms.  Each
pass is a function ``(module: ModuleInfo) -> list[Finding]`` registered
in ``PASSES``; ``run_checks`` walks every ``*.py`` under a root (default
``src/repro_torch``), runs the selected passes, and applies two
suppression channels:

* inline: a ``# trilint: ok[rule]`` comment on the flagged line (or the
  line directly above it) suppresses findings for that rule;
  ``# trilint: ok`` suppresses all rules on that line.
* allowlist file: lines of the form ``<path-glob> <rule|*> <substring|*>``
  (``#`` starts a comment).  A finding matches when its repo-relative path
  matches the glob, the rule matches, and the substring occurs in the
  message.  The port's file is ``src/repro_torch/check/trilint.allow``.

Passes are pure ``ast`` + stdlib so the lint CLI runs without torch or
numpy installed (the runtime half in ``repro_torch.check.runtime`` is
separate).
"""

from __future__ import annotations

import ast
import fnmatch
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Optional

# ---------------------------------------------------------------------------
# Finding model


@dataclass
class Finding:
    """One diagnostic emitted by a lint pass."""

    rule: str  # pass name, e.g. "overflow"
    code: str  # stable rule code, e.g. "O1-sum-dtype"
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    snippet: str = ""
    suppressed: bool = False
    suppression: str = ""  # "inline" | "allowlist:<line>" when suppressed

    def to_dict(self) -> dict:
        return {
            "rule": self.rule,
            "code": self.code,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet,
            "suppressed": self.suppressed,
            "suppression": self.suppression,
        }

    def render(self) -> str:
        mark = " (suppressed)" if self.suppressed else ""
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}/{self.code}]{mark} {self.message}"


@dataclass
class ModuleInfo:
    """A parsed source module handed to each pass."""

    path: Path  # absolute
    rel: str  # posix path relative to the scan root's parent (e.g. "core/engine.py")
    source: str
    lines: list[str] = field(default_factory=list)
    tree: Optional[ast.AST] = None

    def snippet(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, code: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            rule=rule,
            code=code,
            path=self.rel,
            line=line,
            col=col,
            message=message,
            snippet=self.snippet(line),
        )


# ---------------------------------------------------------------------------
# Pass registry

PassFn = Callable[[ModuleInfo], "list[Finding]"]

PASSES: "dict[str, PassFn]" = {}


def register_pass(name: str) -> Callable[[PassFn], PassFn]:
    def deco(fn: PassFn) -> PassFn:
        PASSES[name] = fn
        return fn

    return deco


def load_passes() -> "dict[str, PassFn]":
    """Import the pass modules so their ``register_pass`` decorators run."""
    from . import backend_protocol  # noqa: F401
    from . import codec  # noqa: F401
    from . import collectives  # noqa: F401
    from . import obs_discipline  # noqa: F401
    from . import overflow  # noqa: F401
    from . import recompile  # noqa: F401
    from . import stats_lifecycle  # noqa: F401

    return dict(PASSES)


# ---------------------------------------------------------------------------
# Module walking


def load_module(path: Path, rel: str) -> Optional[ModuleInfo]:
    try:
        source = path.read_text()
    except OSError:
        return None
    mod = ModuleInfo(path=path, rel=rel, source=source, lines=source.splitlines())
    try:
        mod.tree = ast.parse(source, filename=str(path))
    except SyntaxError:
        mod.tree = None
    return mod


def iter_modules(root: Path) -> Iterable[ModuleInfo]:
    """Yield every parseable ``*.py`` under ``root`` (sorted, skipping caches)."""
    root = root.resolve()
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(root).as_posix()
        mod = load_module(path, rel)
        if mod is not None:
            yield mod


# ---------------------------------------------------------------------------
# Inline suppression

_SUPPRESS_RE = re.compile(r"#\s*trilint:\s*ok(?:\[([a-z0-9_,\s-]+)\])?")


def _suppressed_rules(line: str) -> Optional[set]:
    """Return the rule set suppressed by ``line`` (empty set = all rules)."""
    m = _SUPPRESS_RE.search(line)
    if not m:
        return None
    if m.group(1) is None:
        return set()
    return {r.strip() for r in m.group(1).split(",") if r.strip()}


def apply_inline_suppressions(mod: ModuleInfo, findings: "list[Finding]") -> None:
    for f in findings:
        for lineno in (f.line, f.line - 1):
            if not (1 <= lineno <= len(mod.lines)):
                continue
            rules = _suppressed_rules(mod.lines[lineno - 1])
            if rules is None:
                continue
            if not rules or f.rule in rules or f.code in rules:
                f.suppressed = True
                f.suppression = "inline"
                break


# ---------------------------------------------------------------------------
# Allowlist

@dataclass
class AllowRule:
    path_glob: str
    rule: str  # pass name, code, or "*"
    substring: str  # substring of message, or "*"
    lineno: int  # line in the allowlist file (for provenance)

    def matches(self, f: Finding) -> bool:
        if not fnmatch.fnmatch(f.path, self.path_glob):
            return False
        if self.rule not in ("*", f.rule, f.code):
            return False
        if self.substring != "*" and self.substring not in f.message:
            return False
        return True


def parse_allowlist(text: str) -> "list[AllowRule]":
    rules = []
    for i, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split(None, 2)
        while len(parts) < 3:
            parts.append("*")
        rules.append(AllowRule(parts[0], parts[1], parts[2], i))
    return rules


def apply_allowlist(findings: "list[Finding]", rules: "list[AllowRule]") -> None:
    for f in findings:
        if f.suppressed:
            continue
        for r in rules:
            if r.matches(f):
                f.suppressed = True
                f.suppression = f"allowlist:{r.lineno}"
                break


# ---------------------------------------------------------------------------
# Running the passes


def run_checks(
    root: Path,
    allowlist_path: Optional[Path] = None,
    select: Optional[Iterable[str]] = None,
) -> "list[Finding]":
    """Run the selected passes over every module under ``root``.

    Returns all findings with suppression flags already applied; callers
    decide what to do with suppressed ones (the CLI only fails on
    unsuppressed findings).
    """
    passes = load_passes()
    if select:
        wanted = set(select)
        unknown = wanted - set(passes)
        if unknown:
            raise ValueError(f"unknown pass(es): {sorted(unknown)}; have {sorted(passes)}")
        passes = {k: v for k, v in passes.items() if k in wanted}

    allow_rules: "list[AllowRule]" = []
    if allowlist_path is not None and Path(allowlist_path).exists():
        allow_rules = parse_allowlist(Path(allowlist_path).read_text())

    findings: "list[Finding]" = []
    for mod in iter_modules(Path(root)):
        if mod.tree is None:
            findings.append(
                Finding(
                    rule="parse",
                    code="P0-syntax",
                    path=mod.rel,
                    line=1,
                    col=0,
                    message="file does not parse; all passes skipped",
                )
            )
            continue
        mod_findings: "list[Finding]" = []
        for fn in passes.values():
            mod_findings.extend(fn(mod))
        apply_inline_suppressions(mod, mod_findings)
        findings.extend(mod_findings)

    apply_allowlist(findings, allow_rules)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings


# ---------------------------------------------------------------------------
# Shared AST helpers used by several passes


def call_name(node: ast.Call) -> str:
    """Dotted name of a call target: ``torch.sum`` -> "torch.sum", ``f`` -> "f"."""
    return dotted_name(node.func)


def dotted_name(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def has_keyword(node: ast.Call, name: str) -> bool:
    return any(kw.arg == name for kw in node.keywords)


def walk_calls(tree: ast.AST) -> "Iterable[ast.Call]":
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def enclosing_function_stack(tree: ast.AST, target: ast.AST) -> "list[ast.AST]":
    """Return the stack of FunctionDef/AsyncFunctionDef nodes enclosing target.

    Innermost last.  Linear walk with a parent map; fine at repo scale.
    """
    parents: "dict[ast.AST, ast.AST]" = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    stack: "list[ast.AST]" = []
    cur = target
    while cur in parents:
        cur = parents[cur]
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.append(cur)
    stack.reverse()
    return stack


def build_parent_map(tree: ast.AST) -> "dict[ast.AST, ast.AST]":
    parents: "dict[ast.AST, ast.AST]" = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def function_calls(fn: ast.AST) -> "set[str]":
    """All dotted call-target names appearing in a function body."""
    names = set()
    for call in walk_calls(fn):
        name = call_name(call)
        if name:
            names.add(name)
            names.add(name.rsplit(".", 1)[-1])
    return names


# ---------------------------------------------------------------------------
# int32 narrowing forms, numpy and torch (shared by overflow and codec)

INT32_NAMES = {"np.int32", "numpy.int32", "torch.int32"}


def is_int32_expr(node: ast.AST) -> bool:
    """``np.int32`` / ``torch.int32`` / the string ``"int32"``."""
    if dotted_name(node) in INT32_NAMES:
        return True
    return isinstance(node, ast.Constant) and node.value == "int32"


def method_narrowing(call: ast.Call) -> str:
    """How a method call narrows its receiver to int32, or ``""``.

    ``x.astype(np.int32)``, ``x.to(torch.int32)`` (or ``dtype=``),
    ``x.type(torch.int32)`` and ``x.int()``.
    """
    if not isinstance(call.func, ast.Attribute):
        return ""
    attr = call.func.attr
    if attr == "int" and not call.args and not call.keywords:
        return ".int()"
    if attr in ("astype", "to", "type"):
        cands = list(call.args) + [kw.value for kw in call.keywords if kw.arg == "dtype"]
        if any(is_int32_expr(a) for a in cands):
            return f".{attr}(int32)"
    return ""


def int32_dtype_keyword(call: ast.Call) -> bool:
    """The call passes ``dtype=`` an int32 type."""
    return any(kw.arg == "dtype" and is_int32_expr(kw.value) for kw in call.keywords)
