"""Port parity: the dry-run analysis tools of ``repro_torch`` (the cost
walker, the H100 roofline, the production mesh and every dry-run cell).

* **Registry and cells.**  ``REGISTRY``, ``ASSIGNED_CELLS`` and
  ``ALL_CELLS`` equal the reference's; every one of the 46 cells at
  ``baseline``, built on a (1, 1) mesh in both packages, has the
  reference's ``n_params``, ``tokens_per_step``, ``model_flops`` and
  ``description``.
* **Walker.**  ``by_prim["dot_general"]`` of the port's walker equals the
  reference's ``repro.launch.flops.trace_cost`` exactly on the qwen2 smoke
  forward, the smoke train step with accum 2 and remat, the olmoe smoke
  forward (``_moe``'s ``meta`` branch), a ``gcn-cora`` full-graph step,
  the DIN smoke train step and the ``triangles`` smoke cell at
  ``baseline`` and ``opt2``.  The reference's walker counts jax 0.9's
  ``ragged_dot_general`` as elementwise; the port's counts the experts'
  products under ``ragged_dot``, pinned here at 3 · 2·T·k·d·f a layer.
* **Roofline.**  For one made-up ``Hardware`` the port's report equals the
  reference's (NVLink and InfiniBand at the reference's one link rate);
  the H100 constants are the datasheet's; NVLink vs InfiniBand by axes.
* **Collectives.**  The striped per-node count and the sharded smoke train
  step on meshes of repeats of the CPU record what their merges move, and
  their results are bit-equal to runs without the walker.
* **Meta.**  The production meshes; two production cells through
  ``run_cell``; a kernel wrapper refuses ``meta`` tensors.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.configs.triangles as jtri  # noqa: E402
import repro.launch.roofline as jroof  # noqa: E402
from repro.configs.lm_common import make_lm_train_step as jmake_step  # noqa: E402
from repro.launch.flops import trace_cost as ref_trace  # noqa: E402
from repro.launch.mesh import make_local_mesh  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.models.recsys import din as jdin  # noqa: E402
from repro.optim import adamw as jadamw, apply_updates as japply, constant as jconstant  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
import repro_torch.configs.triangles as tri  # noqa: E402
import repro_torch.launch.roofline as roof  # noqa: E402
from repro_torch.configs.lm_common import make_lm_train_step  # noqa: E402
from repro_torch.distributed import Mesh, device_put  # noqa: E402
from repro_torch.launch.dryrun import run_cell  # noqa: E402
from repro_torch.launch.flops import CostWalker, attention_cost, causal_pairs, trace_cost  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.gnn.common import meta_from_layout  # noqa: E402
from repro_torch.models.recsys import din  # noqa: E402

RECORD_KEYS = {
    "arch", "shape", "variant", "mesh", "multi_pod", "chips", "description", "trace_s",
    "memory_analysis", "n_params", "tokens_per_step", "flops_per_device", "bytes_per_device",
    "collective_bytes_per_device", "model_flops", "compute_s", "memory_s", "collective_s",
    "bottleneck", "step_time_s", "useful_flops_ratio", "roofline_fraction", "collectives",
    "xla_flops_per_device", "xla_bytes_per_device", "by_prim",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def meta_mesh(shape=(1, 1)):
    return Mesh(np.full(shape, "meta", dtype=object), ("data", "model"))


def meta(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def dots(cost) -> float:
    return cost["by_prim"].get("dot_general", 0.0)


# ---------------------------------------------------------------------------
# registry and cells
# ---------------------------------------------------------------------------


def test_registry_and_cells_match_reference():
    assert list(configs.REGISTRY) == list(jconfigs.REGISTRY)
    assert configs.ASSIGNED_CELLS == jconfigs.ASSIGNED_CELLS and len(configs.ASSIGNED_CELLS) == 40
    assert configs.ALL_CELLS == jconfigs.ALL_CELLS and len(configs.ALL_CELLS) == 46
    tri_mod = configs.get_arch("triangles")
    assert tri_mod.TRIANGLE_SHAPES == jtri.TRIANGLE_SHAPES
    assert (tri_mod._PANEL_MIX, tri_mod._TAIL_FRACTION) == (jtri._PANEL_MIX, jtri._TAIL_FRACTION)
    assert tri_mod.smoke_config() == jtri.smoke_config() and tri_mod.full_config() == \
        jtri.full_config()
    for arch, mod in configs.REGISTRY.items():
        if mod.FAMILY == "lm":
            assert mod.MICRO_TARGET == jconfigs.REGISTRY[arch].MICRO_TARGET


@pytest.mark.parametrize("arch,shape", jconfigs.ALL_CELLS)
def test_cell_metadata_matches_reference(arch, shape):
    jmesh = make_local_mesh(1, 1)
    with jmesh:
        want = jconfigs.get_arch(arch).build_dryrun(shape, jmesh)
    got = configs.get_arch(arch).build_dryrun(shape, meta_mesh())
    for key in ("n_params", "tokens_per_step", "model_flops", "description"):
        assert getattr(got, key) == getattr(want, key), key


# ---------------------------------------------------------------------------
# the walker against the reference's
# ---------------------------------------------------------------------------


def lm_forward_costs(arch):
    jcfg, cfg = jconfigs.REGISTRY[arch].smoke_config(), configs.REGISTRY[arch].smoke_config()
    jp = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg), jax.random.PRNGKey(0))
    want = ref_trace(lambda p, t: jtfm.forward(p, t, jcfg), jp,
                     jax.ShapeDtypeStruct((2, 64), jnp.int32))
    got = trace_cost(lambda p, t: tfm.forward(p, t, cfg),
                     tfm.TransformerParams(cfg, torch.device("meta")), meta(2, 64))
    return cfg, want, got


def test_walker_matches_reference_on_the_qwen2_forward():
    _, want, got = lm_forward_costs("qwen2-1.5b")
    assert dots(got) == dots(want) > 0
    assert set(got) == {"flops", "bytes", "by_prim", "bytes_by_prim", "warnings"}


def test_walker_matches_reference_on_the_olmoe_forward():
    """``_moe`` on ``meta`` splits the T·k rows evenly over the experts; the
    products count 2·T·k·d·f each whatever the split."""
    cfg, want, got = lm_forward_costs("olmoe-1b-7b")
    assert dots(got) == dots(want) > 0
    t, k = 2 * 64, cfg.top_k
    assert got["by_prim"]["ragged_dot"] == cfg.n_layers * 3 * 2 * t * k * cfg.d_model * cfg.d_ff
    assert "ragged_dot" not in want["by_prim"]  # jax 0.9: ragged_dot_general, elementwise


def test_walker_matches_reference_on_the_train_step_with_remat():
    arch = "qwen2-1.5b"
    jcfg = dataclasses.replace(jconfigs.REGISTRY[arch].smoke_config(), remat=True)
    cfg = dataclasses.replace(configs.REGISTRY[arch].smoke_config(), remat=True)
    jstep, jinit = jmake_step(jcfg, 2)
    jp = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg), jax.random.PRNGKey(0))
    jb = {k: jax.ShapeDtypeStruct((2, 2, 64), jnp.int32) for k in ("tokens", "labels")}
    want = ref_trace(jstep, jp, jax.eval_shape(jinit, jp), jb)
    step, init = make_lm_train_step(cfg, 2)
    params = tfm.TransformerParams(cfg, torch.device("meta"))
    got = trace_cost(step, params, init(params), {k: meta(2, 2, 64) for k in ("tokens", "labels")})
    assert dots(got) == dots(want) > 0
    # the replayed forward is counted: more than one forward and backward
    no_remat, _ = make_lm_train_step(dataclasses.replace(cfg, remat=False), 2)
    plain = trace_cost(no_remat, params, init(params),
                       {k: meta(2, 2, 64) for k in ("tokens", "labels")})
    assert dots(plain) < dots(got)


@pytest.mark.parametrize("arch,shape,variant", [("gcn-cora", "full_graph_sm", "baseline"),
                                                ("gcn-cora", "full_graph_sm", "opt2")])
def test_walker_matches_reference_on_the_gcn_step(arch, shape, variant):
    jmesh = make_local_mesh(1, 1)
    with jmesh:
        spec = jconfigs.get_arch(arch).build_dryrun(shape, jmesh, variant=variant)
        want = ref_trace(spec.step_fn, *spec.args)
    spec = configs.get_arch(arch).build_dryrun(shape, meta_mesh(), variant=variant)
    got = trace_cost(spec.step_fn, *spec.args)
    assert dots(got) == dots(want) > 0


def test_walker_matches_reference_on_the_din_smoke_step():
    jcfg, cfg = jconfigs.REGISTRY["din"].smoke_config(), configs.REGISTRY["din"].smoke_config()
    b, s = 64, jcfg.seq_len
    jp = jax.eval_shape(lambda k: jdin.init_params(k, jcfg), jax.random.PRNGKey(0))
    jinit, jupdate = jadamw(jconstant(1e-3), weight_decay=0.0)

    def jstep(params, opt_state, batch):
        loss, grads = jax.value_and_grad(jdin.loss_fn)(params, jcfg, batch)
        updates, opt_state, _ = jupdate(grads, opt_state, params)
        return japply(params, updates), opt_state, loss

    def batch(make, i32, f32):
        return {"hist_items": make((b, s), i32), "hist_cates": make((b, s), i32),
                "target_item": make((b,), i32), "target_cate": make((b,), i32),
                "label": make((b,), f32)}

    want = ref_trace(jstep, jp, jax.eval_shape(jinit, jp),
                     batch(jax.ShapeDtypeStruct, jnp.int32, jnp.float32))
    step, init = configs.get_arch("din")._train_step(cfg)
    params = meta_from_layout(din._layout(cfg))
    got = trace_cost(step, params, init(params),
                     batch(lambda sh, dt: torch.empty(sh, dtype=dt, device="meta"),
                           torch.int32, torch.float32))
    assert dots(got) == dots(want) > 0


@pytest.mark.parametrize("variant", ["baseline", "opt2"])
def test_walker_matches_reference_on_the_triangle_smoke_cell(variant, monkeypatch):
    monkeypatch.setitem(jtri.TRIANGLE_SHAPES, "smoke", jtri.smoke_config())
    monkeypatch.setitem(tri.TRIANGLE_SHAPES, "smoke", tri.smoke_config())
    jmesh = make_local_mesh(1, 1)
    with jmesh:
        spec = jtri.build_dryrun("smoke", jmesh, variant=variant)
        want = ref_trace(spec.step_fn, *spec.args)
    spec = tri.build_dryrun("smoke", meta_mesh(), variant=variant)
    got = trace_cost(spec.step_fn, *spec.args)
    assert dots(got) == dots(want) == 0  # scalar compares, no matmul
    assert got["flops"] > 0 and got["bytes_by_prim"]["gather"] > 0


def test_walker_charges_attention_by_region():
    """The plain attention's forward, backward and remat replay sum under
    ``attention`` (1×, 2× and 1× the forward's dots); outside it nothing."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.flash_attention.ops import attention

    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = torch.randn(1, 1, 8, 16, requires_grad=True)
    v = torch.randn(1, 1, 8, 16, requires_grad=True)
    with CostWalker() as w, torch.no_grad():
        attention(q, k, v, causal=True)
    fwd = w.report()["by_region"]["attention"]["dot_flops"]
    assert fwd == w.report()["by_prim"]["dot_general"] == 4 * 2 * 8 * 8 * 16
    for remat, times in ((False, 3), (True, 4)):
        with CostWalker() as w:
            if remat:
                out = checkpoint(lambda a, b, c: 2 * attention(a, b, c), q, k, v,
                                 use_reentrant=False)
            else:
                out = 2 * attention(q, k, v, causal=True)
            out.sum().backward()
        rep = w.report()
        assert rep["by_region"]["attention"]["dot_flops"] == rep["by_prim"]["dot_general"] \
            == times * fwd
    flops, n_bytes = attention_cost(1, 2, 1, 8, 8, 16, True, 4)
    assert flops == 4 * 2 * 16 * 36 and n_bytes == 4 * (2 * 2 * 8 * 16 + 2 * 8 * 16)


@pytest.mark.parametrize("sq,skv", [(8, 8), (100, 160), (96, 64), (1, 32768)])
def test_causal_pairs_count_the_bottom_right_mask(sq, skv):
    i = np.arange(sq)
    assert causal_pairs(sq, skv) == int(np.clip(i + (skv - sq) + 1, 0, skv).sum())


# ---------------------------------------------------------------------------
# the roofline
# ---------------------------------------------------------------------------


def test_roofline_report_matches_reference_under_one_hardware():
    stats = {"bytes_by_kind": {"all-reduce": 3e8}, "count_by_kind": {"all-reduce": 2},
             "total_bytes": 3e8, "largest_op_bytes": 2e8}
    by_prim = {"dot_general": 5e15, "elementwise": 1e13}
    want = jroof.RooflineReport(chips=256, flops_per_device=4e13, bytes_per_device=7e10,
                                collective_bytes_per_device=3e8, model_flops=9e15,
                                collectives=stats, hw=jroof.Hardware(1e15, 2e12, 1e11),
                                by_prim=by_prim).to_dict()
    for nvlink in (0.0, 1e8):  # either link: one rate here
        got = roof.RooflineReport(chips=256, flops_per_device=4e13, bytes_per_device=7e10,
                                  collective_bytes_per_device=3e8, model_flops=9e15,
                                  collectives=stats,
                                  hw=roof.Hardware(peak_flops=1e15, hbm_bw=2e12,
                                                   nvlink_bw=1e11, ib_bw=1e11),
                                  by_prim=by_prim, nvlink_bytes_per_device=nvlink).to_dict()
        for key, value in want.items():
            assert got[key] == pytest.approx(value, rel=1e-12) if isinstance(value, float) \
                else got[key] == value, key


def test_h100_constants_are_the_datasheets():
    hw = roof.HW
    assert (hw.peak_flops, hw.tf32_flops, hw.fp32_flops) == (989.4e12, 494.7e12, 66.9e12)
    assert (hw.hbm_bw, hw.nvlink_bw, hw.ib_bw) == (3.35e12, 450e9, 50e9)
    assert hw.peak_for(torch.bfloat16) == 989.4e12 and hw.peak_for(torch.float32) == 66.9e12
    assert hw.peak_for(torch.int32) == 66.9e12  # the triangle cells' scalar compares


def test_collectives_take_nvlink_inside_model_and_infiniband_across():
    recs = [{"kind": "all-gather", "bytes": 900.0, "axes": ["model"], "count": 2},
            {"kind": "all-reduce", "bytes": 100.0, "axes": ["data", "model"], "count": 1},
            {"kind": "reduce-scatter", "bytes": 50.0, "axes": ["data"], "count": 1}]
    stats = roof.collective_stats(recs)
    assert stats["bytes_by_link"] == {"nvlink": 1800.0, "infiniband": 150.0}
    assert stats["count_by_kind"]["all-gather"] == 2 and stats["total_bytes"] == 1950.0
    assert stats["largest_op_bytes"] == 900.0
    rep = roof.RooflineReport(chips=8, flops_per_device=0.0, bytes_per_device=0.0,
                              collective_bytes_per_device=1950.0, model_flops=0.0,
                              collectives=stats, nvlink_bytes_per_device=1800.0)
    assert rep.collective_s == pytest.approx(1800.0 / 450e9 + 150.0 / 50e9)


# ---------------------------------------------------------------------------
# collective records at the merge sites
# ---------------------------------------------------------------------------


def cpu_mesh(shape, names=("data", "model")):
    return Mesh(np.array(["cpu"] * int(np.prod(shape)), dtype=object).reshape(shape), names)


def test_striped_per_node_records_its_merge():
    from repro_torch.core.distributed import striped_workload_fn, stripe_edges
    from repro_torch.core.preprocess import preprocess
    from repro_torch.graphs import kronecker_rmat

    edges = kronecker_rmat(8, edge_factor=8, seed=2)
    csr = preprocess(edges, n_nodes=int(edges.max()) + 1, device="cpu")
    mesh = Mesh(["cpu"] * 4)
    src_sh, dst_sh, budget = stripe_edges(csr, 4)
    steps = math.ceil(math.log2(int(csr.out_degree.max()) + 1))
    f = striped_workload_fn(mesh, "per_node", budget, steps, n_out=csr.n_nodes)
    args = (src_sh, dst_sh, 0, csr.row_offsets, csr.col, csr.out_degree)
    plain = f(*args)
    with CostWalker() as w:
        seen = f(*args)
    assert torch.equal(seen, plain) and int(plain.sum()) > 0
    assert w.collectives == [{"kind": "all-reduce", "bytes": 4.0 * csr.n_nodes,
                              "axes": ["edges"], "count": 1}]


def test_sharded_train_step_records_its_gathers_and_sums():
    cfg = dataclasses.replace(configs.REGISTRY["qwen2-1.5b"].smoke_config(), n_layers=2)
    mesh = cpu_mesh((2, 2))
    from repro_torch.configs import lm_common
    from repro_torch.data import lm_batch
    from repro_torch.optim.optimizers import tree_leaves

    _, psh, rules = lm_common._param_specs(cfg, mesh)
    step, init = make_lm_train_step(cfg, accum=2)
    raw = lm_batch(0, 0, 4, 16, cfg.vocab_size)
    batch = {k: torch.from_numpy(v).reshape(2, 2, 16) for k, v in raw.items()}
    runs = []
    for walk in (False, True):
        params = device_put(tfm.param_tree(tfm.init_params(cfg, 0, device="cpu")), psh)
        opt = init(params)
        if walk:
            with CostWalker() as w:
                params, opt, m = step(params, opt, batch)
        else:
            params, opt, m = step(params, opt, batch)
        runs.append((params, m))
    (p1, m1), (p2, m2) = runs
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a.gather(), b.gather())
    leaves = tree_leaves(p1)
    sharded = [p for p in leaves if p.sharded_axes]
    kinds = [r["kind"] for r in w.collectives]
    # each of the 2 replicas gathers every sharded leaf; one sum per leaf
    assert kinds.count("all-gather") == 2 * len(sharded)
    assert kinds.count("reduce-scatter") == len(sharded)
    assert kinds.count("all-reduce") == len(leaves) - len(sharded)
    gathered = sum(r["bytes"] for r in w.collectives if r["kind"] == "all-gather")
    assert gathered == 2 * sum(p.block_nbytes for p in sharded)
    summed = sum(r["bytes"] for r in w.collectives if r["kind"] != "all-gather")
    assert summed == sum(4 * p.shape.numel() for p in leaves)


# ---------------------------------------------------------------------------
# meta
# ---------------------------------------------------------------------------


def test_production_meshes():
    one, two = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert one.devices.shape == (32, 8) and one.axis_names == ("data", "model")
    assert two.devices.shape == (2, 32, 8) and two.axis_names == ("pod", "data", "model")
    assert (one.size, two.size) == (256, 512)
    assert one.distinct == (torch.device("meta"),)
    # prefill's batch of 32 over the two pods' 64 data devices: padded to one row
    from repro_torch.configs.base import named, per_device_bytes, sds

    assert per_device_bytes(sds((32, 5)), named(two, ("pod", "data"), None)) == 5 * 4
    assert per_device_bytes(sds((512, 8)), named(one, "data", "model")) == 16 * 1 * 4


@pytest.mark.parametrize("arch,shape", [("triangles", "kron16"), ("qwen2-1.5b", "decode_32k")])
def test_run_cell_returns_the_reference_record(arch, shape):
    rec = run_cell(arch, shape, False)
    assert RECORD_KEYS <= set(rec) and "compile_s" not in rec
    assert rec["chips"] == 256 and rec["mesh"] == "32x8"
    for key in ("compute_s", "memory_s", "collective_s", "step_time_s", "roofline_fraction"):
        assert math.isfinite(rec[key]) and rec[key] >= 0, key
    assert rec["memory_s"] > 0 and rec["compute_s"] > 0
    mem = rec["memory_analysis"]
    assert mem["generated_code_bytes"] is None and min(
        mem[k] for k in ("argument_bytes", "output_bytes", "temp_bytes")) > 0
    if arch == "triangles":  # every stripe traced; the partials' merge recorded
        assert rec["collectives"]["count_by_kind"]["all-gather"] == 1
        assert rec["peak_flops"] == roof.HW.fp32_flops and not rec["warnings"]
    else:  # a single-device trace: no collective term, and a warning
        assert rec["collectives"] is None and rec["collective_s"] == 0.0
        assert rec["peak_flops"] == roof.HW.peak_flops and rec["warnings"]


def test_kernel_wrappers_refuse_meta_tensors():
    from repro_torch.kernels.triangle_count import ops

    z = meta(4)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ops.intersect_count_csr(z, z, z, z, 16)
    with pytest.raises(ValueError, match="all CUDA or all CPU"):
        ops.intersect_count(meta(2, 8), meta(2, 8))
    from repro_torch.kernels.flash_attention.flash_attention import flash_attention_cuda

    q = meta(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises((ValueError, RuntimeError)):
        flash_attention_cuda(q, q[:, :1], q[:, :1])


def test_resolve_device_takes_meta_only_when_named():
    from repro_torch._device import resolve_device

    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises((RuntimeError, ValueError)):
        resolve_device(None)  # cuda by default, and no card here
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("xpu")


def test_int8_dot_sums_past_int32_in_int64():
    """``long_500k`` with the int8 cache (``opt``): the value dot over more
    than 133,143 cached tokens can pass int32 (uniform attention, |v| =
    127); the port sums it exactly in int64."""
    from repro_torch.models.attention import _int8_dot

    n = 140_000
    p = torch.full((1, n), 127, dtype=torch.int8)
    v = torch.full((n, 2), -127, dtype=torch.int8)
    got = _int8_dot(p, v)
    assert got.dtype == torch.int64 and got.tolist() == [[-127 * 127 * n] * 2]
    assert _int8_dot(p[:, :2080], v[:2080]).dtype == torch.int32  # the serving shape
    rec = run_cell("qwen2-1.5b", "long_500k", False, variant="opt")
    assert rec["description"].endswith("kv_quant=True") and math.isfinite(rec["memory_s"])
