"""Port parity: the LM training half of ``repro_torch`` against the JAX package.

The reference's parameters (``init_params(PRNGKey(0))``) are carried
across as numpy arrays with ``params_from_numpy`` (and back with
``params_to_numpy``); the same numpy tokens, labels, masks and gradients
then go through both packages, at the reduced ``smoke_config()`` (f32).

Tolerances, f32 on both sides, sums taken in different orders:
optimizers and schedules 1e-6; the loss 1e-5 relative and each gradient
leaf 1e-4 of the leaf's largest magnitude; train-step loss and gradient
norm 1e-4; the port against itself (remat policies, the autograd
Function) 1e-6.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro import data as jdata  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.configs.lm_common import make_lm_train_step as jax_make_lm_train_step  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import data  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.configs.lm_common import make_lm_train_step  # noqa: E402
from repro_torch.kernels.flash_attention import ops as attn_ops  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import flash_attention_torch  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402

LM_ARCHS = sorted(REGISTRY)
OPT = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke models' ops are tiny: torch's thread pool costs more than
    it saves here (a train step 7x slower on 8 threads than on 1)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def carried(arch, **overrides):
    """(port cfg, port params, JAX cfg, JAX params) on the same weights."""
    jcfg = dataclasses.replace(JAX_REGISTRY[arch].smoke_config(), **overrides)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = dataclasses.replace(REGISTRY[arch].smoke_config(), **overrides)
    params = tfm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, params, jcfg, jparams


def lm_tokens(seed, shape):
    toks = np.random.default_rng(seed).integers(0, 250, size=shape).astype(np.int32)
    return toks, np.roll(toks, -1, axis=-1)


def close_leaves(got: dict, want: dict, rel=1e-4):
    """Each leaf within ``rel`` of the reference leaf's largest magnitude."""
    flat_g, flat_w = jax.tree_util.tree_leaves_with_path(got), jax.tree.leaves(want)
    assert len(flat_g) == len(flat_w)
    for (path, g), w in zip(flat_g, flat_w):
        w = np.asarray(w)
        err = float(np.abs(g - w).max())
        assert err <= rel * max(float(np.abs(w).max()), 1e-30), (jax.tree_util.keystr(path), err)


# ---------------------------------------------------------------------------
# optim/
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("linear_warmup", (1e-3, 7)),
    ("cosine_with_warmup", (3e-4, 5, 40, 1e-5)),
])
def test_schedules_match_reference(name, args):
    steps = np.arange(0, 60, dtype=np.int32)
    got = [float(getattr(optim, name)(*args)(torch.tensor(s))) for s in steps]
    want = [float(getattr(joptim, name)(*args)(jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, **OPT)


def opt_tree(rng):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "layers": [{"b": rng.normal(size=(5,)).astype(np.float32)},
                       {"b": rng.normal(size=(5,)).astype(np.float32)}],
            "a": rng.normal(size=(3,)).astype(np.float32)}


@pytest.mark.parametrize("kind,kw", [
    ("adamw", {}),                                            # clip 1.0, wd 0.1
    ("adamw", {"max_grad_norm": None, "weight_decay": 0.0}),
    ("sgd_momentum", {}),
    ("sgd_momentum", {"nesterov": True}),
])
def test_optimizers_match_reference(kind, kw):
    """5 steps fed the same numpy gradients: updates, parameters, moments
    and the gradient norm of each step."""
    rng = np.random.default_rng(3)
    p_np = opt_tree(rng)
    lr = optim.cosine_with_warmup(1e-2, 2, 10) if kind == "adamw" else 0.05
    jlr = joptim.cosine_with_warmup(1e-2, 2, 10) if kind == "adamw" else 0.05
    init, update = getattr(optim, kind)(lr, **kw)
    jinit, jupdate = getattr(joptim, kind)(jlr, **kw)
    params = tree_map(torch.from_numpy, jax.tree.map(np.copy, p_np))
    jparams = jax.tree.map(jnp.asarray, p_np)
    state, jstate = init(params), jinit(jparams)
    for step in range(5):
        g_np = jax.tree.map(lambda x: 3 * rng.normal(size=x.shape).astype(np.float32), p_np)
        upd, state, gnorm = update(tree_map(torch.tensor, g_np), state, params)
        jupd, jstate, jgnorm = jupdate(jax.tree.map(jnp.asarray, g_np), jstate, jparams)
        close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
            np.asarray(a), np.asarray(b), **OPT)
        jax.tree.map(close, tree_map(lambda t: t.numpy(), upd), jupd)
        optim.apply_updates(params, upd)
        jparams = joptim.apply_updates(jparams, jupd)
        jax.tree.map(close, tree_map(lambda t: t.numpy(), params), jparams)
        jax.tree.map(close, tree_map(lambda t: t.numpy(), state.mu), jstate.mu)
        if kind == "adamw":
            jax.tree.map(close, tree_map(lambda t: t.numpy(), state.nu), jstate.nu)
        else:
            assert state.nu is None and jstate.nu is None
        assert int(state.step) == int(jstate.step) == step + 1
        assert (gnorm is None) == (jgnorm is None)
        if gnorm is not None:
            np.testing.assert_allclose(float(gnorm), float(jgnorm), **OPT)


def test_lm_batch_and_pipeline_state_bit_equal():
    for args in ((0, 0, 4, 64, 250), (5, 3, 2, 4096, 152064)):
        got, want = data.lm_batch(*args), jdata.lm_batch(*args)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    pipe, jpipe = data.TokenPipeline(2, 32, 250, seed=9), jdata.TokenPipeline(2, 32, 250, seed=9)
    for _ in range(3):
        np.testing.assert_array_equal(next(pipe)["tokens"], next(jpipe)["tokens"])
    assert pipe.state() == jpipe.state() == {"seed": 9, "step": 3}
    again = data.TokenPipeline.from_state(2, 32, 250, jpipe.state())
    np.testing.assert_array_equal(next(again)["labels"], next(jpipe)["labels"])


# ---------------------------------------------------------------------------
# models/transformer.py: the loss, its gradients, MoE, remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_reference(arch):
    """Both CE branches, the second with a mask, on all five archs."""
    cfg, params, jcfg, jparams = carried(arch)
    toks, labels = lm_tokens(1, (2, 16))
    mask = (np.random.default_rng(2).random((2, 16)) < 0.7).astype(np.float32)
    cases = [(False, None), (True, mask)]

    def jax_both(p):
        out = []
        for onehot, m in cases:
            batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
            if m is not None:
                batch["mask"] = jnp.asarray(m)
            c = dataclasses.replace(jcfg, onehot_ce=onehot)
            out.append(jax.value_and_grad(jtfm.loss_fn)(p, batch, c))
        return out

    for (onehot, m), (jloss, jgrads) in zip(cases, jax.jit(jax_both)(jparams)):
        batch = {"tokens": toks, "labels": labels}
        if m is not None:
            batch["mask"] = m
        c = dataclasses.replace(cfg, onehot_ce=onehot)
        loss = tfm.loss_fn(params, batch, c)
        tree = tfm.param_tree(params)
        grads = torch.autograd.grad(loss, tree_leaves(tree))
        it = iter(grads)
        grads = tfm.params_to_numpy(tree_map(lambda _: next(it), tree))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        close_leaves(grads, jgrads)
        assert all(np.isfinite(g).all() for g in jax.tree.leaves(grads))


def test_padded_vocab_columns_get_no_gradient():
    cfg = REGISTRY["qwen2-1.5b"].smoke_config()
    assert cfg.padded_vocab > cfg.vocab_size
    params = tfm.init_params(cfg, 0, device="cpu")
    toks, labels = lm_tokens(4, (2, 12))
    loss = tfm.loss_fn(params, {"tokens": toks, "labels": labels}, cfg)
    loss.backward()
    assert torch.isfinite(loss)
    assert bool((params.lm_head.grad[:, cfg.vocab_size:] == 0).all())
    assert bool((params.lm_head.grad[:, :cfg.vocab_size] != 0).any())


def moe_inputs(rng, e=4, d=16, ff=24):
    return {"router": rng.normal(size=(d, e)).astype(np.float32),
            "w_gate": (0.1 * rng.normal(size=(e, d, ff))).astype(np.float32),
            "w_up": (0.1 * rng.normal(size=(e, d, ff))).astype(np.float32),
            "w_down": (0.1 * rng.normal(size=(e, ff, d))).astype(np.float32)}


@pytest.mark.parametrize("e,k,t", [(4, 2, 8), (8, 3, 40)])
def test_moe_matches_reference(e, k, t):
    rng = np.random.default_rng(e)
    cfg = dataclasses.replace(REGISTRY["olmoe-1b-7b"].smoke_config(), n_experts=e, top_k=k)
    jcfg = dataclasses.replace(JAX_REGISTRY["olmoe-1b-7b"].smoke_config(), n_experts=e, top_k=k)
    p = moe_inputs(rng, e)
    x = rng.normal(size=(t, 16)).astype(np.float32)
    got = tfm._moe(torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in p.items()}, cfg)
    want = jax.jit(jtfm._moe, static_argnums=2)(jnp.asarray(x),
                                                 {n: jnp.asarray(a) for n, a in p.items()}, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("router", ["zeros", "pairs"])
def test_moe_ties_match_reference(router):
    """Tied router probabilities: the lower expert index goes first, as under
    ``jax.lax.top_k`` (a router of zeros ties all 8; repeated columns tie pairs)."""
    rng = np.random.default_rng(21)
    cfg = dataclasses.replace(REGISTRY["olmoe-1b-7b"].smoke_config(), n_experts=8, top_k=3)
    jcfg = dataclasses.replace(JAX_REGISTRY["olmoe-1b-7b"].smoke_config(), n_experts=8, top_k=3)
    p = moe_inputs(rng, 8, 64, 32)
    if router == "zeros":
        p["router"] = np.zeros_like(p["router"])
    else:
        p["router"] = np.repeat(p["router"][:, :4], 2, axis=1)
    x = rng.normal(size=(6, 64)).astype(np.float32)
    got = tfm._moe(torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in p.items()}, cfg)
    want = jax.jit(jtfm._moe, static_argnums=2)(jnp.asarray(x),
                                                 {n: jnp.asarray(a) for n, a in p.items()}, jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_moe_matches_dense_expert_sum():
    """The reference's identity: identical experts make the MoE the dense
    SwiGLU with the shared weights (the renormalised router weights sum to 1)."""
    rng = np.random.default_rng(0)
    cfg = tfm.TransformerConfig(name="t", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                                d_ff=24, vocab_size=32, n_experts=4, top_k=2,
                                dtype=torch.float32)
    dense = {n: torch.from_numpy(a[0]) for n, a in moe_inputs(rng, 1).items() if n != "router"}
    p = {n: w[None].repeat(4, 1, 1) for n, w in dense.items()}
    p["router"] = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    np.testing.assert_allclose(tfm._moe(x, p, cfg).numpy(),
                               tfm._swiglu(x, dense, torch.float32).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "granite-moe-3b-a800m"])
def test_remat_policies_agree(arch):
    """remat off, full and dots: the same loss and gradients."""
    toks, labels = lm_tokens(5, (2, 12))
    results = []
    for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
        cfg = dataclasses.replace(REGISTRY[arch].smoke_config(), remat=remat,
                                  remat_policy=policy)
        params = tfm.init_params(cfg, 1, device="cpu")
        loss = tfm.loss_fn(params, {"tokens": toks, "labels": labels}, cfg)
        loss.backward()
        results.append((float(loss), [p.grad.clone() for p in params.parameters()]))
    for loss, grads in results[1:]:
        np.testing.assert_allclose(loss, results[0][0], **OPT)
        for g, g0 in zip(grads, results[0][1]):
            np.testing.assert_allclose(g.numpy(), g0.numpy(), **OPT)


def test_kernel_attention_backward_equals_autograd():
    """The autograd Function with the plain forward in the kernel's place
    equals autograd through the plain version (GQA, causal, ragged)."""
    rng = np.random.default_rng(6)
    shapes = ((2, 4, 40, 16), (2, 2, 40, 16), (2, 2, 40, 16))
    qkv = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in shapes]
    grad_out = torch.from_numpy(rng.normal(size=shapes[0]).astype(np.float32))
    outs = []
    for via_function in (True, False):
        inputs = [t.clone().requires_grad_() for t in qkv]
        if via_function:
            o = attn_ops.KernelAttention.apply(*inputs, True, None, flash_attention_torch)
        else:
            o = flash_attention_torch(*inputs, causal=True)
        outs.append((o, torch.autograd.grad(o, inputs, grad_out)))
    np.testing.assert_allclose(outs[0][0].detach().numpy(), outs[1][0].detach().numpy(), **OPT)
    for a, b in zip(outs[0][1], outs[1][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **OPT)


def test_params_to_numpy_inverts_params_from_numpy():
    _, params, _, jparams = carried("granite-moe-3b-a800m")
    back = tfm.params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(jax.tree.map(np.asarray, jparams))
    jax.tree.map(np.testing.assert_array_equal, back, jax.tree.map(np.asarray, jparams))
    moved = tfm.tensors_from_numpy(back, device="cpu")
    assert len(moved["layers"]) == 2 and moved["layers"][1]["router"].shape == (64, 8)


# ---------------------------------------------------------------------------
# configs/lm_common.py: the train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    cfg, params, jcfg, jparams = carried("qwen2-1.5b")
    step, init = make_lm_train_step(cfg, accum, lr=optim.constant(1e-3))
    jstep, jinit = jax_make_lm_train_step(jcfg, accum, lr=joptim.constant(1e-3))
    state, jstate = init(params), jinit(jparams)
    jstep = jax.jit(jstep)
    for i in range(3):
        toks, labels = lm_tokens(10 + i, (accum, 2, 16))
        params, state, m = step(params, state, {"tokens": torch.from_numpy(toks),
                                                "labels": torch.from_numpy(labels)})
        jparams, jstate, jm = jstep(jparams, jstate, {"tokens": jnp.asarray(toks),
                                                      "labels": jnp.asarray(labels)})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]), rtol=1e-4)


def test_training_reduces_loss():
    """The port's counterpart of the reference's test: a few steps on the
    copy-structured stream must reduce CE."""
    cfg = REGISTRY["qwen2-1.5b"].smoke_config()
    params = tfm.init_params(cfg, 0, device="cpu")
    step, init = make_lm_train_step(cfg, accum=1, lr=optim.constant(2e-3))
    state = init(params)
    losses = []
    for i in range(30):
        b = data.lm_batch(0, i, 8, 64, cfg.vocab_size)
        params, state, m = step(params, state, {k: torch.from_numpy(v)[None] for k, v in b.items()})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses


def test_serving_after_a_step_uses_the_new_weights():
    cfg = REGISTRY["llama3.2-3b"].smoke_config()
    params = tfm.init_params(cfg, 2, device="cpu")
    toks, labels = lm_tokens(7, (1, 2, 10))
    before = tfm.forward(params, torch.from_numpy(toks[0]), cfg)
    step, init = make_lm_train_step(cfg, 1, lr=optim.constant(1e-2))
    step(params, init(params), {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    after = tfm.forward(params, torch.from_numpy(toks[0]), cfg)
    fresh = tfm.params_from_numpy(tfm.params_to_numpy(params), cfg, device="cpu")
    assert not torch.allclose(before, after)
    np.testing.assert_array_equal(after.numpy(), tfm.forward(fresh, torch.from_numpy(toks[0]),
                                                             cfg).numpy())


def test_not_yet_ported_parts_raise(tmp_path):
    """``grad_specs=`` and ``shardings=`` are ported (tests/test_torch_sharding.py
    holds the sharded step): on one device the specs change nothing, and a
    sharded restore of an empty directory finds nothing, as the reference's.
    The GNN and recsys archs still raise."""
    from repro_torch.configs.lm_common import _param_specs
    from repro_torch.distributed import Mesh, spec_for

    cfg = REGISTRY["qwen2-1.5b"].smoke_config()
    _, psh, rules = _param_specs(cfg, Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4),
                                           ("data", "model")))
    toks, labels = lm_tokens(4, (1, 2, 12))
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    metrics = []
    for specs in (None, spec_for(rules, tfm.param_tree(tfm.init_params(cfg, 0, device="cpu")))):
        params = tfm.init_params(cfg, 0, device="cpu")
        step, init = make_lm_train_step(cfg, 1, grad_specs=specs, lr=optim.constant(1e-3))
        _, _, m = step(params, init(params), batch)
        metrics.append((float(m["loss"]), float(m["gnorm"]), tfm.params_to_numpy(params)))
    assert metrics[0][:2] == metrics[1][:2]
    for a, b in zip(jax.tree.leaves(metrics[0][2]), jax.tree.leaves(metrics[1][2])):
        np.testing.assert_array_equal(a, b)
    assert ckpt.restore_latest(str(tmp_path / "none"), {}, shardings=psh) is None
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        train_cli.get_arch("din")


# ---------------------------------------------------------------------------
# checkpoint/ and launch/train.py
# ---------------------------------------------------------------------------


def test_train_state_checkpoint_moves_between_packages(tmp_path):
    """``{"params", "opt": OptState}``: the port writes the reference's keys,
    each package restores the other's."""
    cfg, params, jcfg, jparams = carried("olmoe-1b-7b")
    step, init = make_lm_train_step(cfg, 1, lr=optim.constant(1e-3))
    toks, labels = lm_tokens(8, (1, 2, 12))
    params, state, _ = step(params, init(params), {"tokens": torch.from_numpy(toks),
                                                   "labels": torch.from_numpy(labels)})
    tree = train_cli.state_tree(params, state)
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, tree, {"data_state": {"seed": 0, "step": 1}})

    jtarget = {"params": jparams, "opt": joptim.adamw(1e-3)[0](jparams)}
    jtree, jstep_n, extra = jckpt.restore_checkpoint(str(tmp_path / "port" / "step_000000001"),
                                                     jtarget)
    assert jstep_n == 1 and extra == {"data_state": {"seed": 0, "step": 1}}
    assert int(jtree["opt"].step) == 1
    port_flat, ref_flat = ckpt.checkpoint._flatten(tree), jckpt.checkpoint._flatten(jtree)
    assert list(port_flat) == list(ref_flat)
    assert {"params/layers/wq", "opt/.step", "opt/.mu/layers/router", "opt/.nu/embed"} <= set(port_flat)
    for key, value in port_flat.items():
        np.testing.assert_array_equal(ref_flat[key], value, err_msg=key)

    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jtree)
    back, n, _ = ckpt.restore_latest(str(tmp_path / "ref"), train_cli.state_tree(
        tfm.init_params(cfg, 5, device="cpu"), init(params)))
    assert n == 1 and isinstance(back["opt"], optim.OptState)
    for key, value in ckpt.checkpoint._flatten(back).items():
        np.testing.assert_array_equal(port_flat[key], value, err_msg=key)
    fresh = tfm.init_params(cfg, 5, device="cpu")
    restored = train_cli.load_state(fresh, back, torch.device("cpu"))
    assert int(restored.step) == 1 and restored.step.dtype == torch.int32
    for a, b in zip(fresh.parameters(), params.parameters()):
        assert torch.equal(a, b)


def run_train(monkeypatch, capsys, *flags):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "qwen2-1.5b", "--smoke", "--batch", "2",
                                      "--seq", "16", "--device", "cpu", "--log-every", "1",
                                      *flags])
    train_cli.main()
    return capsys.readouterr().out.strip().splitlines()


def test_train_cli_resumes_from_its_checkpoint(tmp_path, monkeypatch, capsys):
    d = str(tmp_path / "ck")
    first = run_train(monkeypatch, capsys, "--steps", "2", "--ckpt", d, "--ckpt-every", "2")
    assert [line.split()[:2] for line in first[:2]] == [["step", "0"], ["step", "1"]]
    resumed = run_train(monkeypatch, capsys, "--steps", "4", "--ckpt", d)
    whole = run_train(monkeypatch, capsys, "--steps", "4", "--ckpt", str(tmp_path / "whole"))
    assert resumed[0] == "resumed from step 2"
    assert resumed[1].startswith("step 2 loss ")
    assert resumed[-2] == whole[-2] and resumed[-2].startswith("step 3 loss ")
    assert resumed[-1].split()[:4] == whole[-1].split()[:4]
    assert resumed[-1].startswith("done: final loss ")
    assert sorted(os.listdir(d)) == ["step_000000002", "step_000000004"]
    # the reference reads the CLI's checkpoint into its own train state
    jcfg = JAX_REGISTRY["qwen2-1.5b"].smoke_config()
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    jtree, n, extra = jckpt.restore_latest(d, {"params": jparams,
                                               "opt": joptim.adamw(1e-3)[0](jparams)})
    assert n == 4 and extra["data_state"] == {"seed": 0, "step": 4}
    assert int(jtree["opt"].step) == 4


def test_train_cli_without_a_card_stops(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "qwen2-1.5b", "--smoke"])
    with pytest.raises(SystemExit) as exc:
        train_cli.main()
    assert "--device cpu" in str(exc.value.code)
    assert capsys.readouterr().out == ""
