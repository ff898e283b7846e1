"""The port's trilint (``python -m repro_torch.check``): torch-idiom fixtures,
compliant forms, the port's tree clean modulo its allowlist, both
suppression channels, the CLI, and parity with the reference's passes.

* every code of every pass is caught on ``tests/fixtures/trilint_torch``
  and the compliant twins there are not;
* ``src/repro_torch`` is clean modulo ``src/repro_torch/check/trilint.allow``;
* on the reference's own fixtures (``tests/fixtures/trilint``) the port's
  backend-protocol, stats-lifecycle and codec passes give exactly the
  reference's (path, line, code) findings;
* the CLI's JSON report on the tree (exit 0) and on the fixtures (exit 1),
  and it runs with no torch importable.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.check import PASSES, load_passes, run_checks
from repro_torch.check.base import parse_allowlist

REPO = Path(__file__).resolve().parents[1]
SRC_PORT = REPO / "src" / "repro_torch"
FIXTURES = Path(__file__).resolve().parent / "fixtures" / "trilint_torch"
REF_FIXTURES = Path(__file__).resolve().parent / "fixtures" / "trilint"
ALLOWLIST = SRC_PORT / "check" / "trilint.allow"
ALL_PASSES = {"overflow", "recompile", "collectives", "backend_protocol",
              "stats_lifecycle", "obs_discipline", "codec"}


def unsuppressed(findings, path):
    return [f for f in findings if f.path == path and not f.suppressed]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


# ---------------------------------------------------------------------------
# each pass catches every code of its torch-idiom fixture


@pytest.mark.parametrize(
    "passname,fixture,expected",
    [
        ("overflow", "core/bad_overflow.py",
         {"O1-sum-dtype": 3, "O2-host-fold": 3, "O3-narrow": 3}),
        ("collectives", "core/bad_collectives.py",
         {"C1-axis-undeclared": 2, "C2-stripe-index-in-core": 1, "C3-mesh-axis-names": 1}),
        ("backend_protocol", "core/bad_backend_protocol.py",
         {"B1-capability-unimplemented": 1, "B2-no-capability-table": 1,
          "B3-undeclared-capability": 2, "B4-missing-plan": 1}),
        ("stats_lifecycle", "core/bad_stats_lifecycle.py", {"S1-stale-stats": 1}),
        ("codec", "core/bad_codec.py", {"Z1-unchecked-decode-narrow": 3}),
        ("obs_discipline", "core/bad_obs_discipline.py", {"D1-unsynced-span": 2}),
    ],
)
def test_pass_flags_torch_fixture(passname, fixture, expected):
    """Every code, and no more: the compliant twins in each fixture pass."""
    found = unsuppressed(run_checks(FIXTURES, select=[passname]), fixture)
    got = {}
    for f in found:
        got[f.code] = got.get(f.code, 0) + 1
    assert got == expected, [f.render() for f in found]


@pytest.mark.parametrize(
    "passname,fixture,flagged,clean",
    [
        ("overflow", "core/bad_overflow.py",
         {"chunk_total", "running_offsets", "scatter_incidences", "host_fold_total",
          "host_fold_item", "host_fold_numpy", "bucket_indices", "degree_histogram",
          "row_offsets"},
         {"total_int64", "total_widened", "guarded_indices", "chunk_partial", "host_wide"}),
        ("codec", "core/bad_codec.py", {"unguarded_to", "unguarded_int", "unguarded_tensor"},
         {"guarded_to"}),
        ("obs_discipline", "core/bad_obs_discipline.py", {"unsynced_csr", "unsynced_stripe"},
         {"synced_span", "event_pair", "synchronized", "host_read", "host_only"}),
        ("collectives", "core/bad_collectives.py",
         {"stripes_of", "count_fn_for", "rank_dependent", "default_axes"},
         {"merged", "edge_stripes", "named_mesh", "replicated"}),
    ],
)
def test_compliant_forms_not_flagged(passname, fixture, flagged, clean):
    """Map each finding to its enclosing function: every violating function
    is flagged and no compliant twin is."""
    import ast

    tree = ast.parse((FIXTURES / fixture).read_text())
    spans = [(fn.name, fn.lineno, fn.end_lineno) for fn in tree.body
             if isinstance(fn, ast.FunctionDef)]
    hit = set()
    for f in unsuppressed(run_checks(FIXTURES, select=[passname]), fixture):
        hit |= {name for name, lo, hi in spans if lo <= f.line <= hi}
    assert hit == flagged
    assert not hit & clean


def test_chunk_partial_is_suppressed_inline():
    found = [f for f in run_checks(FIXTURES, select=["overflow"])
             if f.path == "core/bad_overflow.py" and f.suppressed]
    assert [f.suppression for f in found] == ["inline"]


def test_stats_lifecycle_compliant_method_not_flagged():
    found = run_checks(FIXTURES, select=["stats_lifecycle"])
    flagged = {f.message.split("`")[1] for f in found}
    assert flagged == {"LeakyStream.insert"}


def test_recompile_pass_is_registered_and_empty():
    assert set(load_passes()) == ALL_PASSES and set(PASSES) >= ALL_PASSES
    assert run_checks(FIXTURES, select=["recompile"]) == []
    assert run_checks(SRC_PORT, select=["recompile"]) == []
    with pytest.raises(ValueError, match="unknown pass"):
        run_checks(FIXTURES, select=["pallas"])


# ---------------------------------------------------------------------------
# the port's tree is clean, and the reference's passes agree on B, S and Z


def test_src_repro_torch_clean_modulo_allowlist():
    findings = run_checks(SRC_PORT, allowlist_path=ALLOWLIST)
    bad = [f for f in findings if not f.suppressed]
    assert not bad, "\n".join(f.render() for f in bad)
    # every suppression is inline, where its reason is written beside it
    assert {f.suppression for f in findings if f.suppressed} <= {"inline"}


def test_every_inline_ok_in_the_port_says_why():
    """Each inline ``ok`` in the port carries its reason on its own line."""
    bare = []
    for path in sorted(SRC_PORT.rglob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), start=1):
            if "# trilint: ok" in line:
                reason = line.split("# trilint: ok", 1)[1].split("]", 1)[-1].strip(" —-:")
                if not reason:
                    bare.append(f"{path.relative_to(REPO)}:{i}")
    assert not bare, bare


def test_reference_fixtures_give_the_reference_findings():
    from repro.check import run_checks as ref_run_checks

    select = ["backend_protocol", "stats_lifecycle", "codec"]
    want = [(f.path, f.line, f.code) for f in ref_run_checks(REF_FIXTURES, select=select)]
    got = [(f.path, f.line, f.code) for f in run_checks(REF_FIXTURES, select=select)]
    assert want and got == want
    assert {p for p, _, _ in got} == {"core/bad_backend_protocol.py",
                                      "core/bad_stats_lifecycle.py", "core/bad_codec.py"}


# ---------------------------------------------------------------------------
# suppression channels


def test_inline_suppression(tmp_path):
    core = tmp_path / "core"
    core.mkdir()
    (core / "mod.py").write_text(
        "import torch\n"
        "def f(x):\n"
        "    return x.sum(dtype=torch.int32)  # trilint: ok[overflow]\n"
        "def g(x):\n"
        "    return x.sum(dtype=torch.int32)\n"
        "def h(x):\n"
        "    # trilint: ok[O1-sum-dtype] — by code, on the line above\n"
        "    return x.cumsum(0, dtype=torch.int32)\n"
    )
    by_line = {f.line: f for f in run_checks(tmp_path, select=["overflow"])}
    assert by_line[3].suppressed and by_line[3].suppression == "inline"
    assert not by_line[5].suppressed
    assert by_line[8].suppressed


def test_allowlist_matching(tmp_path):
    core = tmp_path / "core"
    core.mkdir()
    (core / "mod.py").write_text(
        "import torch\ndef f(x):\n    return x.to(torch.int32)\n"
        "def g(m):\n    return torch.nonzero(m).int()\n"
    )
    allow = tmp_path / "allow.txt"
    allow.write_text("# reviewed\ncore/*.py O3-narrow *\n")
    findings = run_checks(tmp_path, allowlist_path=allow, select=["overflow"])
    assert len(findings) == 1 and findings[0].suppressed
    assert findings[0].suppression == "allowlist:2"
    assert not run_checks(tmp_path, select=["overflow"])[0].suppressed


def test_parse_allowlist_shapes():
    rules = parse_allowlist("# c\ncore/x.py overflow substr\ncore/y.py\n")
    assert len(rules) == 2
    assert rules[0].substring == "substr"
    assert rules[1].rule == "*" and rules[1].substring == "*"
    # the port's file parses, and holds no entry that no finding needs
    assert parse_allowlist(ALLOWLIST.read_text()) == []


# ---------------------------------------------------------------------------
# CLI


def test_cli_json_clean_on_port_tree():
    r = subprocess.run([sys.executable, "-m", "repro_torch.check", "--json"],
                       capture_output=True, text=True, env=_env(), timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    report = json.loads(r.stdout)
    assert report["counts"]["unsuppressed"] == 0
    assert report["counts"]["suppressed"] > 0
    assert Path(report["root"]).resolve() == SRC_PORT
    assert Path(report["allowlist"]).resolve() == ALLOWLIST
    assert set(report["passes"]) == ALL_PASSES


def test_cli_fails_on_fixtures_and_lists_passes():
    r = subprocess.run([sys.executable, "-m", "repro_torch.check", "--root", str(FIXTURES),
                        "--no-allowlist", "--json"],
                       capture_output=True, text=True, env=_env(), timeout=120)
    assert r.returncode == 1
    report = json.loads(r.stdout)
    assert report["counts"]["unsuppressed"] >= 20
    assert {f["code"][:2] for f in report["findings"]} == {
        "O1", "O2", "O3", "C1", "C2", "C3", "B1", "B2", "B3", "B4", "S1", "Z1", "D1"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.check", "--select", "recompile",
                        "--root", str(FIXTURES)],
                       capture_output=True, text=True, env=_env(), timeout=120)
    assert r.returncode == 0 and "0 finding(s)" in r.stdout
    r = subprocess.run([sys.executable, "-m", "repro_torch.check", "--select", "nope"],
                       capture_output=True, text=True, env=_env(), timeout=120)
    assert r.returncode == 2


def test_cli_needs_no_torch():
    """The static passes are stdlib only: the CLI runs with torch unimportable."""
    code = ("import sys\n"
            "sys.modules['torch'] = None\nsys.modules['numpy'] = None\n"
            "from repro_torch.check.__main__ import main\n"
            "sys.exit(main(['--list-passes']))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr
    assert set(r.stdout.split()) == ALL_PASSES
