"""The benchmark runs the port alone: no module of ``tcbench`` imports JAX
or the JAX package, and the yardstick imports nothing of the port."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
MODULES = sorted(BENCH.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
YARDSTICK = [BENCH / "reference", BENCH / "gen", BENCH / "roofline.py"]


def imported_top_levels(path: Path) -> set[str]:
    """Top-level names (the part before the first dot) of every absolute import."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                names.add(arg.value.split(".")[0])
    return names


def in_yardstick(path: Path) -> bool:
    return any(path == y or y in path.parents for y in YARDSTICK)


def test_found_the_modules():
    assert BENCH / "run.py" in MODULES and len(MODULES) > 10


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    found = imported_top_levels(path) & FORBIDDEN
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", [p for p in MODULES if in_yardstick(p)],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_nothing_of_the_port(path):
    assert "repro_torch" not in imported_top_levels(path), path


def test_the_whole_word_is_compared():
    # repro_torch begins with repro; only the whole top-level name counts
    tree = ast.parse("import repro_torch.core\nfrom repro_torch import obs\n")
    names = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    assert names == {"repro_torch"} and not names & FORBIDDEN


def test_reads_nothing_of_the_old_benchmarks():
    for path in MODULES:
        if path == Path(__file__).resolve():
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "benchmarks/" not in node.value, path
