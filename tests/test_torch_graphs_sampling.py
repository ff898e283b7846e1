"""Port parity: the fanout sampler, the block graph, the synthetic positions
and the molecule batching of ``repro_torch`` against the JAX package.

All bit for bit: the sampler given the reference's own uniforms gives its
frontiers, and the integer and numpy paths are the reference's arithmetic.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs import gnn_common as jgc  # noqa: E402
from repro.graphs import batching as jbatching  # noqa: E402
from repro.graphs import erdos_renyi  # noqa: E402
from repro.graphs import sample_blocks as jsample_blocks  # noqa: E402
from repro.graphs.formats import edge_array_to_csr  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.configs import gnn_common as gc  # noqa: E402
from repro_torch.graphs import collate_graphs, random_molecule_batch, sample_blocks  # noqa: E402
from repro_torch.graphs.sampling import _blocks_from_uniforms  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

FANOUTS = (4, 3)


@pytest.fixture(scope="module")
def csr():
    """erdos_renyi(60, 150) with 10 more nodes of degree 0 at the end."""
    e = erdos_renyi(60, 150, seed=2)
    n = int(e.max()) + 1 + 10
    row, col = edge_array_to_csr(e, n)
    return n, np.asarray(row, np.int32), np.asarray(col, np.int32)


def reference_uniforms(key, n_seeds, fanouts):
    """The uniforms the reference's ``sample_blocks`` draws from ``key``."""
    out, rows = [], n_seeds
    for fanout in fanouts:
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (rows, fanout))))
        rows *= fanout
    return out


@pytest.mark.parametrize("key_seed", [0, 1, 5])
def test_frontiers_bit_equal_given_reference_uniforms(csr, key_seed):
    n, row, col = csr
    seeds = np.concatenate([np.arange(0, 12), np.arange(n - 6, n)]).astype(np.int32)
    key = jax.random.PRNGKey(key_seed)
    want = jsample_blocks(key, jnp.asarray(row), jnp.asarray(col), jnp.asarray(seeds), FANOUTS)
    u = reference_uniforms(key, len(seeds), FANOUTS)
    got = _blocks_from_uniforms(torch.from_numpy(row), torch.from_numpy(col),
                                torch.from_numpy(seeds), FANOUTS,
                                [torch.from_numpy(np.array(a)) for a in u])
    assert len(got.frontiers) == len(want.frontiers) == len(FANOUTS) + 1
    for g, w in zip(got.frontiers, want.frontiers):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the zero-degree seeds (the last six) fall back to self-loops
    assert (got.frontiers[1].reshape(-1, FANOUTS[0])[-6:].numpy() == seeds[-6:, None]).all()


def test_sample_blocks_with_a_generator(csr):
    n, row, col = csr
    seeds = torch.arange(n, dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    blocks = sample_blocks(gen, torch.from_numpy(row), torch.from_numpy(col), seeds, FANOUTS)
    assert [f.shape[0] for f in blocks.frontiers] == [n, n * 4, n * 12]
    for parents, children, f in zip(blocks.frontiers, blocks.frontiers[1:], FANOUTS):
        for p, kids in zip(parents.tolist(), children.reshape(-1, f).tolist()):
            nbrs = set(col[row[p]:row[p + 1]].tolist()) or {p}
            assert set(kids) <= nbrs, (p, kids)
    again = sample_blocks(torch.Generator().manual_seed(3), torch.from_numpy(row),
                          torch.from_numpy(col), seeds, FANOUTS)
    assert all(torch.equal(a, b) for a, b in zip(blocks.frontiers, again.frontiers))


def test_block_graph_and_positions_bit_equal(csr):
    n, row, col = csr
    blocks = jsample_blocks(jax.random.PRNGKey(4), jnp.asarray(row), jnp.asarray(col),
                            jnp.arange(9, dtype=jnp.int32), FANOUTS)
    want = jgc.block_graph_from_frontiers(blocks.frontiers, FANOUTS)
    got = gc.block_graph_from_frontiers([torch.from_numpy(np.array(f))
                                         for f in blocks.frontiers], FANOUTS)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids = np.concatenate([np.arange(5000), [2**31 - 1, 2**31 - 2, 232964, 2449028, 65535, 65536],
                          np.random.default_rng(0).integers(0, 2**31 - 1, size=2000)]
                         ).astype(np.int32)
    np.testing.assert_array_equal(gc._synth_positions(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jgc._synth_positions(jnp.asarray(ids))))


def test_molecule_batching_bit_equal():
    for args in ((4, 10, 18, 12), (128, 30, 64, 16), (3, 7, 5, 2)):
        got, want = random_molecule_batch(*args, seed=1), jbatching.random_molecule_batch(*args,
                                                                                          seed=1)
        assert got._fields == want._fields
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    rng = np.random.default_rng(0)
    graphs = [{"node_feat": rng.normal(size=(3, 2)).astype(np.float32),
               "edges": np.array([[0, 1], [1, 2]])},
              {"node_feat": rng.normal(size=(5, 2)).astype(np.float32),
               "positions": rng.normal(size=(5, 3)).astype(np.float32),
               "edges": np.array([[4, 0]])}]
    for g, w in zip(collate_graphs(graphs, 6, 3, 2), jbatching.collate_graphs(graphs, 6, 3, 2)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="padding budget"):
        collate_graphs(graphs, 4, 3, 2)


@pytest.mark.parametrize("arch", ["gcn-cora", "graphsage-reddit", "schnet", "egnn"])
def test_minibatch_step_samples_inside_the_step(arch, csr):
    """The ``minibatch_lg`` step at the smoke config: the sampler runs in the
    step (seeds 8, fanout 15-10 of the shape), two steps on the CPU, finite
    loss, the parameters moved."""
    n, row, col = csr
    mod = REGISTRY[arch]
    cfg = mod.smoke_config()
    step, opt_init, got = gc._minibatch_step(mod.MODEL, lambda f, c: cfg, "minibatch_lg")
    assert got is cfg and JAX_REGISTRY[arch].SHAPES == mod.SHAPES
    params = mod.MODEL.init_params(cfg, 0, device="cpu")
    before = [p.clone() for p in tree_leaves(params)]
    opt = opt_init(params)
    rng = np.random.default_rng(1)
    feat = torch.from_numpy(rng.normal(size=(n, cfg.d_in)).astype(np.float32))
    seeds = torch.arange(8, dtype=torch.int32)
    labels = torch.from_numpy(rng.integers(0, cfg.d_out, size=8).astype(np.int32))
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        params, opt, m = step(params, opt, gen, torch.from_numpy(row), torch.from_numpy(col),
                              feat, seeds, labels)
        assert np.isfinite(float(m["loss"]))
    assert any(not torch.equal(a, b) for a, b in zip(before, tree_leaves(params)))


@pytest.mark.parametrize("arch", ["schnet", "egnn"])
def test_molecule_step_matches_reference_step(arch):
    """The ``molecule`` step against the reference's jitted dry-run step on
    the same batch (smoke config): the loss 1e-5 relative over three steps."""
    mod, jmod = REGISTRY[arch], JAX_REGISTRY[arch]
    jcfg = jmod.smoke_config()
    jparams = jmod.MODEL.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = mod.smoke_config()
    params = mod.MODEL.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    spec = jgc.build_gnn_dryrun(arch, jmod.MODEL, lambda f, c: jcfg, "molecule",
                                jax.make_mesh((1,), ("data",)), 1.0, 1.0)
    step, opt_init, _ = gc._molecule_step(mod.MODEL, lambda f, c: cfg, "molecule")
    gb = random_molecule_batch(4, 30, 64, cfg.d_in, seed=0)
    labels = np.random.default_rng(2).normal(size=4).astype(np.float32)
    arrays = (gb.node_feat, gb.positions, gb.edge_src, gb.edge_dst, labels)
    from repro.optim import adamw as jadamw, constant as jconstant

    jstep = jax.jit(spec.step_fn)
    jopt, opt = jadamw(jconstant(1e-3), weight_decay=0.0)[0](jparams), opt_init(params)
    for _ in range(3):
        jparams, jopt, jm = jstep(jparams, jopt, *map(jnp.asarray, arrays))
        params, opt, m = step(params, opt, *(torch.from_numpy(np.array(a)) for a in arrays))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
