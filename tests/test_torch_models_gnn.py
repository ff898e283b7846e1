"""Port parity: the four GNN archs of ``repro_torch`` against the JAX package.

The reference's parameters (``init_params(PRNGKey(0))`` at each arch's
``smoke_config()``) are carried across with ``params_from_numpy``, and the
same numpy inputs (the reference fixture ``erdos_renyi(50, 200, seed=0)``
with 12 features) go through both packages.  Tolerances: forward 1e-5
(absolute and relative), gradients 1e-4 of each leaf's max — f32 on both
sides, sums taken in another order; three AdamW steps: the loss 1e-5
relative, parameters 2e-3 (a weight whose near-zero gradient flips sign
moves by about ±2·lr); the edge-partitioned GCN 2e-4 in f32 (the
reference's shard_map test) and 3e-2 of the output's max in bf16.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import gnn_common as jgc  # noqa: E402
from repro.data import graph_node_features  # noqa: E402
from repro.graphs import erdos_renyi, random_molecule_batch  # noqa: E402
from repro.graphs import sample_blocks as jsample_blocks  # noqa: E402
from repro.graphs.formats import edge_array_to_csr  # noqa: E402
from repro.models.gnn import common as jcommon  # noqa: E402
from repro.models.gnn import gcn as jgcn  # noqa: E402
from repro.optim import adamw as jadamw, constant as jconstant  # noqa: E402
from repro_torch.configs import REGISTRY, get_arch  # noqa: E402
from repro_torch.configs import gnn_common as gc  # noqa: E402
from repro_torch.configs.base import value_and_grad  # noqa: E402
from repro_torch.distributed import Mesh, NamedSharding, P, device_put  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.gnn import common, gcn  # noqa: E402
from repro_torch.optim import adamw, apply_updates, constant  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

GNN_ARCHS = [a for a, m in REGISTRY.items() if m.FAMILY == "gnn"]
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD_REL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a))


def carried(arch, seed=0):
    """(port cfg, port params, JAX cfg, JAX params) on the same weights."""
    jcfg = JAX_REGISTRY[arch].smoke_config()
    jparams = JAX_REGISTRY[arch].MODEL.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = REGISTRY[arch].smoke_config()
    params = REGISTRY[arch].MODEL.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                    device="cpu")
    return cfg, params, jcfg, jparams


def assert_leaves_close(got_tree, want_tree, rel):
    got, want = tree_leaves(got_tree), jax.tree.leaves(want_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=rel * max(float(np.abs(w).max()), 1e-30))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke models' ops are tiny: torch's thread pool costs more than
    it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mean_sq(out):
    return jnp.mean(out ** 2), out


@pytest.fixture(scope="module")
def graph():
    e = erdos_renyi(50, 200, seed=0)
    n = int(e.max()) + 1
    rng = np.random.default_rng(0)
    return {"edges": e, "n": n,
            "feat": rng.normal(size=(n, 12)).astype(np.float32),
            "pos": rng.normal(size=(n, 3)).astype(np.float32)}


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_forward_and_grads_match_reference(arch, graph):
    cfg, params, jcfg, jparams = carried(arch)
    model, jmodel = REGISTRY[arch].MODEL, JAX_REGISTRY[arch].MODEL
    src, dst = graph["edges"][:, 0], graph["edges"][:, 1]
    jargs = (jnp.asarray(graph["feat"]), jnp.asarray(graph["pos"]), jnp.asarray(src),
             jnp.asarray(dst))
    args = (t(graph["feat"]), t(graph["pos"]), t(src), t(dst))
    (jloss, want), jgrads = jax.jit(jax.value_and_grad(
        lambda p: _mean_sq(jmodel.apply(p, jcfg, *jargs)), has_aux=True))(jparams)
    got = model.apply(params, cfg, *args)
    assert got.shape == (graph["n"], cfg.d_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)
    loss, grads = value_and_grad(lambda p: torch.mean(model.apply(p, cfg, *args) ** 2), params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert_leaves_close(grads, jgrads, GRAD_REL)
    assert not any(p.requires_grad for p in tree_leaves(params))


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_padded_edges_are_ignored(arch, graph):
    cfg, params, _, _ = carried(arch)
    model = REGISTRY[arch].MODEL
    src, dst = t(graph["edges"][:, 0]), t(graph["edges"][:, 1])
    pad = torch.full((37,), -1, dtype=torch.int32)
    feat, pos = t(graph["feat"]), t(graph["pos"])
    out1 = model.apply(params, cfg, feat, pos, src, dst)
    out2 = model.apply(params, cfg, feat, pos, torch.cat([src, pad]), torch.cat([dst, pad]))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_minibatch_block_path_on_reference_frontiers(arch, graph):
    """The reference's own sampled frontiers (PRNGKey(1), fanout (3, 2)),
    through ``apply_blocks`` (GraphSAGE) or the linearized block graph."""
    cfg, params, jcfg, jparams = carried(arch)
    model, jmodel = REGISTRY[arch].MODEL, JAX_REGISTRY[arch].MODEL
    row, col = edge_array_to_csr(graph["edges"], graph["n"])
    blocks = jsample_blocks(jax.random.PRNGKey(1), jnp.asarray(row, jnp.int32),
                            jnp.asarray(col, jnp.int32), jnp.arange(8, dtype=jnp.int32), (3, 2))
    jfeat, jpos = jnp.asarray(graph["feat"]), jnp.asarray(graph["pos"])
    if hasattr(jmodel, "apply_blocks"):
        want = jax.jit(jmodel.apply_blocks, static_argnums=(1, 3))(
            jparams, jcfg, [jnp.take(jfeat, f, axis=0) for f in blocks.frontiers], (3, 2))
        got = model.apply_blocks(params, cfg, [t(graph["feat"]).index_select(0, t(f))
                                               for f in blocks.frontiers], (3, 2))
    else:
        jnodes, jsrc, jdst = jgc.block_graph_from_frontiers(blocks.frontiers, (3, 2))
        want = jax.jit(jmodel.apply, static_argnums=1)(
            jparams, jcfg, jnp.take(jfeat, jnodes, axis=0), jnp.take(jpos, jnodes, axis=0),
            jsrc, jdst)[:8]
        nodes, src, dst = gc.block_graph_from_frontiers([t(f) for f in blocks.frontiers], (3, 2))
        got = model.apply(params, cfg, t(graph["feat"]).index_select(0, nodes),
                          t(graph["pos"]).index_select(0, nodes), src, dst)[:8]
    assert got.shape == (8, cfg.d_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_molecule_batched(arch):
    cfg, params, jcfg, jparams = carried(arch)
    model, jmodel = REGISTRY[arch].MODEL, JAX_REGISTRY[arch].MODEL
    gb = random_molecule_batch(4, 10, 18, cfg.d_in, seed=0)
    b, nb = 4, 10
    off = (np.arange(b, dtype=np.int32) * nb)[:, None]
    arrays = (gb.node_feat.reshape(b * nb, -1), gb.positions.reshape(b * nb, 3),
              np.where(gb.edge_src >= 0, gb.edge_src + off, -1).reshape(-1),
              np.where(gb.edge_dst >= 0, gb.edge_dst + off, -1).reshape(-1))
    want = jax.jit(jmodel.apply, static_argnums=1)(jparams, jcfg, *map(jnp.asarray, arrays))
    got = model.apply(params, cfg, *map(t, arrays))
    assert got.shape == (b * nb, cfg.d_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def test_egnn_equivariance(graph):
    cfg, params, _, _ = carried("egnn")
    model = REGISTRY["egnn"].MODEL
    src, dst = t(graph["edges"][:, 0]), t(graph["edges"][:, 1])
    th = 1.1
    rot = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0], [0, 0, 1.0]],
                   np.float32)
    moved = graph["pos"] @ rot.T + np.array([3.0, -1.0, 2.0], np.float32)
    out1 = model.apply(params, cfg, t(graph["feat"]), t(graph["pos"]), src, dst)
    out2 = model.apply(params, cfg, t(graph["feat"]), t(moved), src, dst)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=2e-3, atol=2e-3)


def test_gcn_training_reduces_loss(graph):
    """The reference's gate (tests/test_models_gnn.py): 60 AdamW steps at
    3e-2 lower the loss by more than 0.3."""
    feat, labels = graph_node_features(0, graph["n"], 12, 3)
    cfg, params, _, _ = carried("gcn-cora")
    opt_init, opt_update = adamw(constant(3e-2), weight_decay=0.0)
    opt = opt_init(params)
    src, dst = t(graph["edges"][:, 0]), t(graph["edges"][:, 1])
    feat, labels = t(feat), t(labels).to(torch.int64)

    def loss(p):
        lp = torch.log_softmax(gcn.apply(p, cfg, feat, None, src, dst), dim=-1)
        return -torch.mean(lp.gather(-1, labels[:, None]))

    losses = []
    for _ in range(60):
        value, grads = value_and_grad(loss, params)
        updates, opt, _ = opt_update(grads, opt, params)
        apply_updates(params, updates)
        losses.append(float(value))
    assert losses[-1] < losses[0] - 0.3, losses


@pytest.mark.parametrize("arch", GNN_ARCHS)
def test_full_step_matches_reference_step(arch, graph):
    """Three steps of the port's full-shape step against the reference's
    jitted ``build_gnn_dryrun`` step on a one-device mesh (both at the
    smoke config, AdamW constant(1e-3))."""
    cfg, params, jcfg, jparams = carried(arch)
    jmod, mod = JAX_REGISTRY[arch], REGISTRY[arch]
    spec = jgc.build_gnn_dryrun(arch, jmod.MODEL, lambda f, c: jcfg, "full_graph_sm",
                                jax.make_mesh((1,), ("data",)), 1.0, 1.0)
    step, opt_init, got_cfg = gc._full_step(mod.MODEL, lambda f, c: cfg, "full_graph_sm")
    assert got_cfg is cfg
    feat, labels = graph_node_features(1, graph["n"], cfg.d_in, cfg.d_out)
    arrays = (feat, graph["pos"], graph["edges"][:, 0], graph["edges"][:, 1], labels)
    jstep = jax.jit(spec.step_fn)
    jopt = jadamw(jconstant(1e-3), weight_decay=0.0)[0](jparams)
    opt = opt_init(params)
    for i in range(3):
        jparams, jopt, jm = jstep(jparams, jopt, *map(jnp.asarray, arrays))
        params, opt, m = step(params, opt, *map(t, arrays))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert int(opt.step) == int(jopt.step) == 3
    for g, w in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype,smart_order,tol", [
    (torch.float32, False, 2e-4), (torch.float32, True, 2e-4), (torch.bfloat16, True, 3e-2)])
def test_edge_partitioned_gcn_matches_single_device(dtype, smart_order, tol):
    """The reference's shard_map test restated on the port's mesh: eight
    repeats of the CPU split the −1-padded edge lists along ``data``; the
    output is held against the reference's single-device ``gcn.apply``
    (2e-4, as that test; bf16 3e-2 of the output's max, where the eight
    partial aggregates are summed in bf16 in another order: 0.0045 and
    0.0090 of the max with and without ``smart_order``), and so is the
    port's single-device forward (2e-4, bf16 included)."""
    e = erdos_renyi(48, 200, seed=0)
    n = int(e.max()) + 1
    pad = (-e.shape[0]) % 8
    src = np.concatenate([e[:, 0], -np.ones(pad)]).astype(np.int32)
    dst = np.concatenate([e[:, 1], -np.ones(pad)]).astype(np.int32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jcfg = jgcn.GCNConfig(d_in=12, d_hidden=16, d_out=5, smart_order=smart_order, dtype=jdt)
    jp = jgcn.init_params(jax.random.PRNGKey(0), jcfg)
    feat = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (n, 12)))
    want = np.asarray(jax.jit(jgcn.apply, static_argnums=(1, 3))(
        jp, jcfg, jnp.asarray(feat), None, jnp.asarray(src), jnp.asarray(dst)).astype(jnp.float32))
    cfg = gcn.GCNConfig(d_in=12, d_hidden=16, d_out=5, smart_order=smart_order, dtype=dtype,
                        psum_axes=("data",))
    p = gcn.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    mesh = Mesh(["cpu"] * 8, ("data",))
    sharding = NamedSharding(mesh, P("data"))
    s_src, s_dst = device_put(t(src), sharding), device_put(t(dst), sharding)
    assert len(s_src.unique_blocks()) == 8
    got = gcn.apply(p, cfg, t(feat), None, s_src, s_dst, mesh=mesh)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * (1.0 if dtype == torch.float32
                                           else float(np.abs(want).max())))
    # on one device the port's bf16 forward is the reference's (2e-4)
    single = gcn.apply(p, dataclasses.replace(cfg, psum_axes=None), t(feat), None, t(src), t(dst))
    np.testing.assert_allclose(single.float().numpy(), want, rtol=2e-4, atol=2e-4)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
        _, grads = value_and_grad(
            lambda q: torch.sum(gcn.apply(q, cfg, t(feat), None, s_src, s_dst, mesh=mesh) ** 2), p)
        assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


def test_edge_partitioned_gcn_needs_a_mesh():
    """``psum_axes`` without ``mesh=`` raises, as the reference's psum does
    outside shard_map; ``mesh=`` without ``psum_axes``, or edge lists not
    split along them, raise too."""
    cfg = gcn.GCNConfig(d_in=4, d_hidden=8, d_out=2)
    p = gcn.init_params(cfg, 0, device="cpu")
    feat = torch.ones((6, 4))
    e = torch.tensor([0, 1, 2, 3], dtype=torch.int32)
    mesh = Mesh(["cpu"] * 2, ("data",))
    with pytest.raises(ValueError, match="needs mesh="):
        gcn.apply(p, dataclasses.replace(cfg, psum_axes=("data",)), feat, None, e, e)
    with pytest.raises(ValueError, match="psum_axes"):
        gcn.apply(p, cfg, feat, None, e, e, mesh=mesh)
    with pytest.raises(ValueError, match="ShardedTensor"):
        gcn.apply(p, dataclasses.replace(cfg, psum_axes=("data",)), feat, None, e, e, mesh=mesh)
    rep = device_put(e, NamedSharding(mesh, P()))
    with pytest.raises(ValueError, match="split along"):
        gcn.apply(p, dataclasses.replace(cfg, psum_axes=("data",)), feat, None, rep, rep,
                  mesh=mesh)


def test_params_from_numpy_rejects_wrong_trees():
    cfg, _, jcfg, jparams = carried("schnet")
    tree = jax.tree.map(np.asarray, jparams)
    tree["interactions"][1]["filter"][0]["w"] = tree["interactions"][1]["filter"][0]["w"][:, :4]
    with pytest.raises(ValueError, match=r"interactions\[1\]/filter\[0\]/w"):
        REGISTRY["schnet"].MODEL.params_from_numpy(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["interactions"].pop()
    with pytest.raises(ValueError, match="interactions"):
        REGISTRY["schnet"].MODEL.params_from_numpy(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    del tree["readout"]
    with pytest.raises(ValueError, match="readout"):
        REGISTRY["schnet"].MODEL.params_from_numpy(tree, cfg, device="cpu")
    back = REGISTRY["schnet"].MODEL.params_to_numpy(
        REGISTRY["schnet"].MODEL.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                   device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("fn", ["scatter_sum", "scatter_mean", "scatter_max",
                                "degrees_from_edges"])
def test_scatter_primitives_match_reference(fn):
    """The segment ops on −1-padded edges, the reference's quirks included:
    a −1 ``dst`` lands on node 0, and ``scatter_max`` of a node whose only
    incoming edges are padded reads −1e30, not 0."""
    rng = np.random.default_rng(3)
    msg = rng.normal(size=(40, 5)).astype(np.float32)
    src = rng.integers(-1, 9, size=40).astype(np.int32)
    dst = rng.integers(-1, 9, size=40).astype(np.int32)
    cases = [(msg, src, dst, 12),
             (np.array([[1.0], [2.0], [5.0]], np.float32), np.zeros(3, np.int32),
              np.array([1, 1, -1], np.int32), 3)]
    for m, s, d, n in cases:
        jmask = jcommon.edge_mask(jnp.asarray(s), jnp.asarray(d))
        mask = common.edge_mask(t(s), t(d))
        if fn == "degrees_from_edges":
            want = jcommon.degrees_from_edges(jnp.asarray(d), n, jmask)
            got = common.degrees_from_edges(t(d), n, mask)
        else:
            want = getattr(jcommon, fn)(jnp.asarray(m), jnp.asarray(d), n, jmask)
            got = getattr(common, fn)(t(m), t(d), n, mask)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    if fn == "scatter_max":
        assert got[:, 0].tolist() == [float(np.float32(-1e30)), 2.0, 0.0]


def test_rbf_centres_are_jnp_linspace():
    cfg = REGISTRY["schnet"].make_cfg(16, 1)
    from repro_torch.models.gnn.schnet import _rbf_centres

    np.testing.assert_array_equal(_rbf_centres(cfg, "cpu").numpy(),
                                  np.asarray(jnp.linspace(0.0, cfg.cutoff, cfg.n_rbf)))


def test_gnn_archs_resolve_and_the_dry_run_waits():
    for arch in GNN_ARCHS:
        mod = get_arch(arch)
        assert mod.FAMILY == "gnn" and mod.SHAPES == JAX_REGISTRY[arch].SHAPES
        assert dataclasses.asdict(mod.make_cfg(602, 41)).keys() == \
            dataclasses.asdict(JAX_REGISTRY[arch].make_cfg(602, 41)).keys()
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            mod.build_dryrun("full_graph_sm", None)
    assert gc.GNN_SHAPES == jgc.GNN_SHAPES


def test_train_cli_trains_gcn_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "gcn-cora", "--steps", "30",
                                      "--device", "cpu"])
    train_cli.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("step 0 loss ") and lines[-2].startswith("step 29 loss ")
    assert lines[-1].startswith("done: final loss ")
    assert float(lines[-1].split()[3]) < float(lines[0].split()[3])
