"""Port parity: DIN and the EmbeddingBag utilities of ``repro_torch``
against the JAX package.

The reference's six DIN/EmbeddingBag cases restated on the port, and the
port held to the reference on the same numpy inputs with the reference's
parameters carried across: logits and the loss within 1e-5, gradients
within 1e-4 of each leaf's max (f32 on both sides, sums in another order),
the bag reduces within 1e-6, ``hash_bucket`` bit for bit.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.data import din_batch  # noqa: E402
from repro.models.recsys import din as jdin  # noqa: E402
from repro.models.recsys import embedding as jemb  # noqa: E402
from repro_torch.configs import REGISTRY, get_arch  # noqa: E402
from repro_torch.configs.base import value_and_grad  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models.recsys import (  # noqa: E402
    din, embedding_bag, embedding_lookup, hash_bucket)
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def carried(seed=0):
    jcfg = JAX_REGISTRY["din"].smoke_config()
    jparams = jdin.init_params(jax.random.PRNGKey(seed), jcfg)
    cfg = REGISTRY["din"].smoke_config()
    return cfg, din.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu"), \
        jcfg, jparams


def batches(cfg, b=6, seed=0, step=0):
    """(the port's batch, the reference's) from the same numpy arrays."""
    arrays = din_batch(seed, step, b, cfg.seq_len, cfg.n_items, cfg.n_cates)
    return ({k: torch.from_numpy(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


def test_apply_and_grads():
    cfg = REGISTRY["din"].smoke_config()
    params = din.init_params(cfg, 0, device="cpu")
    batch, _ = batches(cfg)
    logits = din.apply(params, cfg, batch)
    assert logits.shape == (6,)
    loss, grads = value_and_grad(lambda p: din.loss_fn(p, cfg, batch), params)
    assert np.isfinite(float(loss))
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


def test_apply_loss_and_grads_match_reference():
    cfg, params, jcfg, jparams = carried()
    batch, jbatch = batches(cfg, b=16, seed=3)
    np.testing.assert_allclose(din.apply(params, cfg, batch).numpy(),
                               np.asarray(jdin.apply(jparams, jcfg, jbatch)), **TOL)
    jloss, jgrads = jax.jit(jax.value_and_grad(jdin.loss_fn), static_argnums=1)(
        jparams, jcfg, jbatch)
    loss, grads = value_and_grad(lambda p: din.loss_fn(p, cfg, batch), params)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    got, want = tree_leaves(grads), jax.tree.leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * float(np.abs(w).max()))


def test_history_padding_is_masked():
    cfg = REGISTRY["din"].smoke_config()
    params = din.init_params(cfg, 0, device="cpu")
    batch, _ = batches(cfg)
    # replacing padded (−1) history slots with arbitrary ids must not matter
    junk = torch.where(batch["hist_items"] < 0, 7, batch["hist_items"])
    batch2 = dict(batch, hist_items=torch.where(batch["hist_items"] < 0, -1, junk))
    np.testing.assert_allclose(din.apply(params, cfg, batch).numpy(),
                               din.apply(params, cfg, batch2).numpy(), **TOL)


def test_score_candidates_matches_apply_and_reference():
    cfg, params, jcfg, jparams = carried()
    batch, jbatch = batches(cfg, b=1)
    c = 32
    cands = {"hist_items": batch["hist_items"], "hist_cates": batch["hist_cates"],
             "cand_items": torch.arange(c, dtype=torch.int32),
             "cand_cates": torch.arange(c, dtype=torch.int32) % cfg.n_cates}
    scores = din.score_candidates(params, cfg, cands)
    # candidate i must equal apply() with target=i
    batch_rep = {"hist_items": batch["hist_items"].repeat(c, 1),
                 "hist_cates": batch["hist_cates"].repeat(c, 1),
                 "target_item": cands["cand_items"], "target_cate": cands["cand_cates"]}
    np.testing.assert_allclose(scores.numpy(), din.apply(params, cfg, batch_rep).numpy(),
                               rtol=1e-4, atol=1e-4)
    want = jdin.score_candidates(jparams, jcfg, {k: jnp.asarray(v.numpy())
                                                 for k, v in cands.items()})
    np.testing.assert_allclose(scores.numpy(), np.asarray(want), **TOL)


def test_embedding_bag_modes_match_manual(rng):
    table = torch.from_numpy(rng.normal(size=(50, 6)).astype(np.float32))
    ids = torch.tensor([3, 4, 5, -1, 9, 9, 2])
    segs = torch.tensor([0, 0, 0, 1, 1, 2, 2])
    t = table.numpy()
    want_sum = np.stack([t[3] + t[4] + t[5], t[9], t[9] + t[2]])
    np.testing.assert_allclose(embedding_bag(table, ids, segs, 3, "sum").numpy(), want_sum,
                               rtol=1e-6)
    want_mean = np.stack([(t[3] + t[4] + t[5]) / 3, t[9], (t[9] + t[2]) / 2])
    np.testing.assert_allclose(embedding_bag(table, ids, segs, 3, "mean").numpy(), want_mean,
                               rtol=1e-6)
    want_max = np.stack([np.maximum(np.maximum(t[3], t[4]), t[5]), t[9], np.maximum(t[9], t[2])])
    np.testing.assert_allclose(embedding_bag(table, ids, segs, 3, "max").numpy(), want_max,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="unknown mode"):
        embedding_bag(table, ids, segs, 3, "min")


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode):
    """Random bags with −1 ids, −1 segments (clamped to bag 0), a bag of
    padding only and an empty bag."""
    rng = np.random.default_rng(7)
    table = rng.normal(size=(30, 5)).astype(np.float32)
    ids = rng.integers(-1, 30, size=60).astype(np.int32)
    segs = rng.integers(-1, 8, size=60).astype(np.int32)
    ids[segs == 5] = -1   # bag 5: padding only
    segs[segs == 6] = 7   # bag 6: empty
    want = jemb.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(segs), 9, mode)
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(segs),
                        9, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert not got[5].any() and not got[6].any()


def test_lookup_padding_and_hash():
    table = torch.ones((10, 4))
    out = embedding_lookup(table, torch.tensor([-1, 3]))
    assert (out[0].numpy() == 0).all() and (out[1].numpy() == 1).all()
    h = hash_bucket(torch.arange(1000), 32)
    assert h.dtype == torch.int32 and int(h.min()) >= 0 and int(h.max()) < 32
    assert len(np.unique(h.numpy())) == 32  # spreads


def test_hash_bucket_is_bit_equal_to_reference():
    """uint32 wraparound: negative ids and ids near 2^31."""
    ids = np.concatenate([np.array([-5, 3, 2**31 - 1, 123456789, -2**31, -1, 0], np.int32),
                          np.random.default_rng(1).integers(-2**31, 2**31 - 1, size=4096,
                                                            dtype=np.int64).astype(np.int32)])
    for n in (1000, 32, 2**31 - 1, 7):
        want = np.asarray(jemb.hash_bucket(jnp.asarray(ids), n))
        got = hash_bucket(torch.from_numpy(ids), n).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert hash_bucket(torch.tensor([-5, 3, 2**31 - 1, 123456789], dtype=torch.int32),
                       1000).tolist() == [379, 987, 183, 93]


def test_din_training_reduces_loss():
    """The reference's gate: 40 AdamW steps at 3e-3 on 64-row batches."""
    from repro_torch.optim import adamw, apply_updates, constant

    cfg = REGISTRY["din"].smoke_config()
    params = din.init_params(cfg, 0, device="cpu")
    opt_init, opt_update = adamw(constant(3e-3), weight_decay=0.0)
    opt = opt_init(params)
    losses = []
    for i in range(40):
        batch, _ = batches(cfg, b=64, step=i)
        loss, grads = value_and_grad(lambda p: din.loss_fn(p, cfg, batch), params)
        updates, opt, _ = opt_update(grads, opt, params)
        apply_updates(params, updates)
        losses.append(float(loss))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.02, losses


def test_train_step_matches_reference_steps():
    """Three steps of the ``train_batch`` step (AdamW constant(1e-3)) against
    the reference's optimizer on the same batches: the loss 1e-5 relative,
    parameters 2e-3."""
    from repro.optim import adamw as jadamw, apply_updates as japply, constant as jconstant

    cfg, params, jcfg, jparams = carried()
    step, opt_init = REGISTRY["din"]._train_step(cfg)
    opt = opt_init(params)
    jinit, jupdate = jadamw(jconstant(1e-3), weight_decay=0.0)

    @jax.jit
    def jstep(p, o, b):
        loss, g = jax.value_and_grad(jdin.loss_fn)(p, jcfg, b)
        u, o, _ = jupdate(g, o, p)
        return japply(p, u), o, loss

    jopt = jinit(jparams)
    for i in range(3):
        batch, jbatch = batches(cfg, b=32, step=i)
        jparams, jopt, jloss = jstep(jparams, jopt, jbatch)
        params, opt, m = step(params, opt, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jloss), rtol=1e-5)
    for g, w in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3)


def test_din_resolves_and_the_dry_run_waits():
    mod = get_arch("din")
    assert mod.FAMILY == "recsys" and mod.SHAPES == JAX_REGISTRY["din"].SHAPES
    assert mod.DIN_SHAPES == JAX_REGISTRY["din"].DIN_SHAPES
    full, jfull = mod.full_config(), JAX_REGISTRY["din"].full_config()
    assert (full.n_items, full.n_cates, full.embed_dim, full.seq_len, full.attn_mlp, full.mlp) \
        == (jfull.n_items, jfull.n_cates, jfull.embed_dim, jfull.seq_len, jfull.attn_mlp,
            jfull.mlp)
    for call in (lambda: mod.build_dryrun("train_batch", None),
                 lambda: mod._param_shardings(None, None),
                 lambda: mod._flops(full, 1, 1, True)):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            call()


def test_train_cli_trains_din_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "din", "--steps", "10",
                                      "--device", "cpu"])
    train_cli.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[:2] for line in lines[:-1]] == [["step", "0"], ["step", "5"],
                                                         ["step", "9"]]
    assert lines[-1].startswith("done: final loss ")
    assert np.isfinite(float(lines[-1].split()[3]))
