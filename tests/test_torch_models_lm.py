"""Port parity: the LM serving path of ``repro_torch`` against the JAX package.

Dense (qwen2, llama3.2) and MoE (olmoe, granite) archs alike.
The reference's parameters (``init_params(PRNGKey(0))``) are carried
across as numpy arrays with ``params_from_numpy``; the same numpy tokens
then go through both packages' ``forward``, ``prefill``, ``decode_step``
and greedy serving loop, at the reduced ``smoke_config()`` (f32).

Tolerance: 1e-4 (absolute and relative) on logits and caches — f32 on
both sides, with matrix products and softmax sums taken in different
orders.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import REGISTRY, get_arch  # noqa: E402
from repro_torch.kernels.flash_attention import _build as fa_build  # noqa: E402
from repro_torch.kernels.flash_attention import launches, reset_launches  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402

DENSE = ["qwen2-1.5b", "llama3.2-3b"]
ARCHS = DENSE + ["olmoe-1b-7b", "granite-moe-3b-a800m"]
TOL = dict(rtol=1e-4, atol=1e-4)
_DT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def carried(arch):
    """(port cfg, port params, JAX cfg, JAX params) on the same weights."""
    jcfg = JAX_REGISTRY[arch].smoke_config()
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = REGISTRY[arch].smoke_config()
    params = tfm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return cfg, params, jcfg, jparams


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The smoke models' ops are tiny: torch's thread pool costs more than
    it saves here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return carried(request.param)


@pytest.fixture(scope="module", params=DENSE)
def dense_models(request):
    """The serving loop's archs (the MoE layer's serving parity is held by
    forward, prefill and decode above)."""
    return carried(request.param)


@pytest.fixture(scope="module")
def toks():
    return np.random.default_rng(1).integers(0, 250, size=(2, 24)).astype(np.int32)


@pytest.mark.parametrize("arch", sorted(a for a, m in REGISTRY.items() if m.FAMILY == "lm"))
def test_configs_match_reference(arch):
    for make in ("full_config", "smoke_config"):
        mine = getattr(REGISTRY[arch], make)()
        ref = getattr(JAX_REGISTRY[arch], make)()
        a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
        assert _DT[a.pop("dtype")] == b.pop("dtype")
        assert _DT[a.pop("param_dtype")] == b.pop("param_dtype")
        assert a == b, make
        assert (mine.padded_vocab, mine.head_dim, mine.n_params()) == \
            (ref.padded_vocab, ref.head_dim, ref.n_params())
    assert REGISTRY[arch].FAMILY == "lm" and REGISTRY[arch].SHAPES == JAX_REGISTRY[arch].SHAPES


def test_forward_matches_reference(models, toks):
    cfg, params, jcfg, jparams = models
    got = tfm.forward(params, torch.from_numpy(toks), cfg)
    want = jtfm.forward(jparams, jnp.asarray(toks), jcfg)
    assert got.shape == (2, 24, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert bool((got.argmax(-1) < cfg.vocab_size).all())


def test_prefill_matches_reference(models, toks):
    cfg, params, jcfg, jparams = models
    last, (k, v) = tfm.prefill(params, torch.from_numpy(toks), cfg)
    jlast, (jk, jv) = jtfm.prefill(jparams, jnp.asarray(toks), jcfg)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **TOL)
    assert k.shape == (cfg.n_layers, 2, cfg.n_kv_heads, 24, cfg.head_dim)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)


def test_decode_step_matches_reference(models, toks):
    cfg, params, jcfg, jparams = models
    s = toks.shape[1]
    last, kv = tfm.prefill(params, torch.from_numpy(toks), cfg)
    jlast, jkv = jtfm.prefill(jparams, jnp.asarray(toks), jcfg)
    k0, v0 = tfm.init_kv_cache(cfg, 2, s + 8, dtype=torch.float32, device="cpu")
    k0[:, :, :, :s] = kv[0]
    v0[:, :, :, :s] = kv[1]
    jk0, jv0 = jtfm.init_kv_cache(jcfg, 2, s + 8, dtype=jnp.float32)
    jk0 = jax.lax.dynamic_update_slice(jk0, jkv[0], (0, 0, 0, 0, 0))
    jv0 = jax.lax.dynamic_update_slice(jv0, jkv[1], (0, 0, 0, 0, 0))
    nxt = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    logits, (k1, v1) = tfm.decode_step(params, torch.from_numpy(nxt), s, (k0, v0), cfg)
    jlogits, (jk1, jv1) = jtfm.decode_step(jparams, jnp.asarray(nxt), jnp.int32(s),
                                           (jk0, jv0), jcfg)
    assert logits.dtype == torch.float32 and logits.shape == (2, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    np.testing.assert_allclose(k1.numpy(), np.asarray(jk1), **TOL)
    np.testing.assert_allclose(v1.numpy(), np.asarray(jv1), **TOL)
    # decode of one token equals the full forward's last row (the reference's check)
    full = tfm.forward(params, torch.from_numpy(np.concatenate([toks, nxt[:, None]], 1)), cfg)
    np.testing.assert_allclose(logits.numpy(), full[:, -1].numpy(), rtol=3e-4, atol=3e-4)


def test_serve_matches_reference_greedy_loop(dense_models):
    cfg, params, jcfg, jparams = dense_models
    prompts = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(3, 16)).astype(np.int32)
    gen = 6
    toks, timings = serve_cli.serve(cfg, params, torch.from_numpy(prompts), gen)
    assert toks.shape == (3, gen) and toks.dtype == torch.int32
    assert timings["decode_steps"] == gen - 1

    last, kv = jtfm.prefill(jparams, jnp.asarray(prompts), jcfg)
    k0, v0 = jtfm.init_kv_cache(jcfg, 3, 16 + gen, dtype=jcfg.dtype)
    cache = (jax.lax.dynamic_update_slice(k0, kv[0], (0, 0, 0, 0, 0)),
             jax.lax.dynamic_update_slice(v0, kv[1], (0, 0, 0, 0, 0)))
    tok = jnp.argmax(last, -1).astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        logits, cache = jtfm.decode_step(jparams, tok, jnp.int32(16 + i), cache, jcfg)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jnp.stack(want, axis=1)))


def test_cpu_serving_never_builds_the_kernel(dense_models, monkeypatch):
    cfg, params, _, _ = dense_models

    def refuse():
        raise AssertionError("the CPU path tried to build or load the CUDA library")

    monkeypatch.setattr(fa_build, "load_library", refuse)
    reset_launches()
    serve_cli.serve(cfg, params, torch.zeros((1, 8), dtype=torch.int32), 2)
    assert launches == {"flash_attention": 0}
    assert fa_build.build_info() is None


def test_init_params_shapes_and_seed():
    cfg = REGISTRY["qwen2-1.5b"].smoke_config()
    a = tfm.init_params(cfg, 3, device="cpu")
    b = tfm.init_params(cfg, 3, device="cpu")
    jshapes = jax.tree.map(lambda x: x.shape, jax.eval_shape(
        lambda k: jtfm.init_params(k, JAX_REGISTRY["qwen2-1.5b"].smoke_config()),
        jax.random.PRNGKey(0)))
    assert tuple(a.embed.shape) == jshapes["embed"]
    assert tuple(a.layers[0].wq.shape) == jshapes["layers"]["wq"][1:]
    assert len(a.layers) == cfg.n_layers
    assert torch.equal(a.layers[1].w_down, b.layers[1].w_down)
    assert torch.equal(a.layers[0].bq, torch.zeros_like(a.layers[0].bq))
    assert all(p.requires_grad for p in a.parameters())  # trainable f32 masters


def test_serve_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-1.5b", "--device", "cpu",
                                      "--batch", "2", "--prompt-len", "12", "--gen", "4"])
    serve_cli.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("prefill: 2×12 tokens in ")
    assert lines[1].startswith("decode: 3 steps × batch 2 in ")
    assert lines[2].startswith("sample continuation ids: [")


def test_serve_cli_without_a_card_stops(monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-1.5b"])
    with pytest.raises(SystemExit) as exc:
        serve_cli.main()
    assert "--device cpu" in str(exc.value.code)
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfm.init_params(REGISTRY["qwen2-1.5b"].smoke_config(), 0)


def test_kv_quant_loss_and_other_archs_are_not_ported():
    """kv_quant is ported: its int8 cache has the reference's shapes and
    dtypes, and a decode step writes the new token into it; the GNN and
    recsys archs resolve (tests/test_torch_models_gnn.py holds them), the
    dry-run ``triangles`` cells still raise."""
    cfg = dataclasses.replace(REGISTRY["llama3.2-3b"].smoke_config(), kv_quant=True)
    jcfg = dataclasses.replace(JAX_REGISTRY["llama3.2-3b"].smoke_config(), kv_quant=True)
    cache = tfm.init_kv_cache_int8(cfg, 2, 8, device="cpu")
    for got, want in zip(cache, jtfm.init_kv_cache_int8(jcfg, 2, 8)):
        assert tuple(got.shape) == want.shape and str(got.dtype)[6:] == str(want.dtype)
    params = tfm.init_params(cfg, 0, device="cpu")
    logits, out = tfm.decode_step(params, torch.zeros((2,), dtype=torch.int32), 0, cache, cfg)
    assert out is cache and bool(torch.isfinite(logits).all())
    assert bool((cache[0][:, :, :, 0] != 0).any()) and bool((cache[1][:, :, :, 0] > 0).all())
    assert not bool(cache[0][:, :, :, 1:].any())
    assert get_arch("gcn-cora").FAMILY == "gnn"
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        get_arch("triangles")
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_params_from_numpy_rejects_wrong_shapes():
    cfg = REGISTRY["qwen2-1.5b"].smoke_config()
    tree = jax.tree.map(np.asarray, jtfm.init_params(jax.random.PRNGKey(0),
                                                      JAX_REGISTRY["qwen2-1.5b"].smoke_config()))
    tree["layers"]["wq"] = tree["layers"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="wq"):
        tfm.params_from_numpy(tree, cfg, device="cpu")
