"""The port's kernel builder: what its library name (the build digest) reads.

A library is rebuilt exactly when its digest changes, so the digest must
cover every file of the family's ``csrc/`` (a ``.cuh`` header a kernel
includes, not only the listed ``.cu`` sources) and the nvcc flags.  Nothing
here runs nvcc.
"""
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

from repro_torch.kernels._build import FLAGS, KernelLibrary  # noqa: E402
from repro_torch.kernels.flash_attention import _build as fa_build  # noqa: E402
from repro_torch.kernels.triangle_count import _build as tc_build  # noqa: E402


def make(tmp_path, flags=FLAGS):
    csrc = tmp_path / "csrc"
    csrc.mkdir(exist_ok=True)
    (csrc / "kernel.cu").write_text('#include "helpers.cuh"\n')
    if not (csrc / "helpers.cuh").exists():
        (csrc / "helpers.cuh").write_text("// v1\n")
    return KernelLibrary("probe", [csrc / "kernel.cu"], lambda lib: lib, flags=flags)


def test_digest_covers_included_headers(tmp_path):
    lib = make(tmp_path)
    before = lib.digest()
    assert make(tmp_path).digest() == before  # stable when nothing changes
    (tmp_path / "csrc" / "helpers.cuh").write_text("// v2\n")
    assert lib.digest() != before


def test_digest_covers_flags(tmp_path):
    assert make(tmp_path).digest() != make(tmp_path, FLAGS + ("-DPROBE",)).digest()


@pytest.mark.parametrize("lib,needed", [
    (fa_build.LIBRARY, {"flash_attention.cu", "hopper.cuh"}),
    (tc_build.LIBRARY, {"intersect.cu", "intersect_csr.cu"}),
])
def test_family_libraries_hash_their_whole_csrc(lib, needed):
    assert needed <= {p.name for p in lib.inputs()}


def test_each_source_gets_its_own_nvcc_then_one_link(tmp_path, monkeypatch):
    """The family's sources compile in parallel, one ``nvcc -c`` each, all
    started before any is waited on; one link makes the library."""
    from repro_torch.kernels import _build

    events = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **_):
            events.append(("start", cmd))
            open(cmd[cmd.index("-o") + 1], "w").close()

        def communicate(self):
            events.append(("wait", None))
            return "", "ptxas info\n"

    def fake_run(cmd, **_):
        events.append(("link", cmd))
        open(cmd[cmd.index("-o") + 1], "w").close()
        return SimpleNamespace(returncode=0, stdout="", stderr="")

    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    out = tmp_path / "libtc.so"
    info = tc_build.LIBRARY._build(out)
    kinds = [k for k, _ in events]
    assert kinds == ["start", "start", "wait", "wait", "link"]
    compiled = [cmd[-1].rsplit("/", 1)[-1] for k, cmd in events if k == "start"]
    assert compiled == ["intersect.cu", "intersect_csr.cu"]
    assert all("-c" in cmd and "-shared" not in cmd for k, cmd in events if k == "start")
    assert "-shared" in events[-1][1] and out.exists()
    assert info["built"] and info["log"].count("ptxas") == 2
