"""Port parity: the int8 KV cache of ``repro_torch`` against the JAX package.

The same numpy K/V/q (made from a fixed seed) go through both packages:

* ``quantize_kv_token``: int8 payloads and f32 scales bit-equal (one f32
  division, rounded half to even, on both sides);
* ``decode_attention_int8`` on the reference's own int8 cache: within 1e-6
  relative to the output's largest magnitude, with a scalar and a (B,)
  ``cache_len`` — both integer dots are exact, the softmax's ``exp`` and
  sums differ by float rounding only;
* the reference's ``test_int8_kv_decode_matches_fp`` gate on carried
  weights (llama3.2-3b smoke config): the cache stays int8, the int8
  decode's logits within 0.08 of the f32 cache's relative to their max,
  the same greedy token; and the port's int8 decode against the
  reference's int8 decode;
* ``serve`` with ``kv_quant`` against the reference's prefill and int8
  decode loop.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.attention import decode_attention_int8, quantize_kv_token  # noqa: E402

DECODE_REL = 1e-6


def rel_to_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 2, 1, 32), (2, 3, 2, 40, 16)])
def test_quantize_kv_token_bit_equal(shape, dtype):
    rng = np.random.default_rng(7)
    k, v = (rng.normal(size=shape).astype(np.float32) * 3 for _ in range(2))
    k[0, 0] = 0.0                      # an all-zero token: the 1e-12 scale floor
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = quantize_kv_token(torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt))
    want = jattn.quantize_kv_token(jnp.asarray(k, jdt), jnp.asarray(v, jdt))
    for g, w, dt in zip(got, want, (torch.int8, torch.float32) * 2):
        assert g.dtype == dt and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def int8_inputs(seed, b=2, hq=8, hkv=2, s=48, d=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, 1, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, s, d)).astype(np.float32) for _ in range(2))
    kq, ks, vq, vs = (np.array(x) for x in jattn.quantize_kv_token(jnp.asarray(k),
                                                                       jnp.asarray(v)))
    return q, kq, ks, vq, vs


@pytest.mark.parametrize("cache_len", [48, 17, "vector"])
def test_decode_attention_int8_matches_reference(cache_len):
    q, kq, ks, vq, vs = int8_inputs(3)
    lens = np.array([9, 48], np.int32) if cache_len == "vector" else cache_len
    got = decode_attention_int8(*(torch.from_numpy(x) for x in (q, kq, ks, vq, vs)),
                                cache_len=torch.from_numpy(lens) if cache_len == "vector"
                                else lens)
    want = jattn.decode_attention_int8(*(jnp.asarray(x) for x in (q, kq, ks, vq, vs)),
                                       cache_len=jnp.asarray(lens))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert rel_to_max(got.numpy(), want) <= DECODE_REL


def test_int8_dots_are_exact_past_the_f32_bound():
    """The value dot over 2,080 keys (qwen2's serving cache) at the int8
    extremes: its sums pass 2²⁴, where an f32 accumulation rounds, and the
    int32 result still equals the int64 one."""
    from repro_torch.models.attention import _int8_dot

    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.integers(120, 128, size=(2, 1, 3, 2080)).astype(np.int8))
    v = torch.from_numpy(rng.integers(120, 128, size=(2, 1, 2080, 16)).astype(np.int8))
    exact = torch.matmul(p.to(torch.int64), v.to(torch.int64))
    assert int(exact.max()) > 1 << 24
    assert torch.equal(_int8_dot(p, v).to(torch.int64), exact)
    # the control: the same dot accumulated in f32 is not exact
    assert not torch.equal(torch.matmul(p.float(), v.float()).to(torch.int64), exact)


@pytest.fixture(scope="module")
def llama():
    jcfg = JAX_REGISTRY["llama3.2-3b"].smoke_config()
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    cfg = REGISTRY["llama3.2-3b"].smoke_config()
    params = tfm.params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 24), 0, 250))
    return cfg, params, jcfg, jparams, toks


def test_int8_kv_decode_matches_fp(llama):
    """The reference's gate, on the port with the reference's weights."""
    cfg, params, jcfg, jparams, toks = llama
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    last, kv = tfm.prefill(params, torch.from_numpy(toks), cfg)
    nxt = torch.argmax(last, -1).to(torch.int32)
    s = toks.shape[1]
    k0, v0 = tfm.init_kv_cache(cfg, 2, s + 8, dtype=torch.float32, device="cpu")
    k0[:, :, :, :s], v0[:, :, :, :s] = kv
    lf, _ = tfm.decode_step(params, nxt, s, (k0, v0), cfg)

    cache = tfm.init_kv_cache_int8(cfgq, 2, s + 8, device="cpu")
    for dst, src in zip(cache, quantize_kv_token(kv[0], kv[1])):
        dst[:, :, :, :s] = src
    lq, newc = tfm.decode_step(params, nxt, s, cache, cfgq)
    assert newc[0].dtype == torch.int8 and newc[2].dtype == torch.int8
    rel = float((lf - lq).abs().max() / lf.abs().max())
    assert rel < 0.08, rel
    assert bool((torch.argmax(lf, -1) == torch.argmax(lq, -1)).all())

    # the port's int8 decode against the reference's on the same weights
    jcfgq = dataclasses.replace(jcfg, kv_quant=True)
    jlast, jkv = jtfm.prefill(jparams, jnp.asarray(toks), jcfg)
    jcache = jtfm.init_kv_cache_int8(jcfgq, 2, s + 8)
    jq = jattn.quantize_kv_token(jkv[0], jkv[1])
    jcache = tuple(jax.lax.dynamic_update_slice(c, x, (0,) * c.ndim)
                   for c, x in zip(jcache, jq))
    for g, w in zip(tfm.init_kv_cache_int8(cfgq, 2, s + 8, device="cpu"), jcache):
        assert g.dtype == torch.from_numpy(np.asarray(w)).dtype and tuple(g.shape) == w.shape
    jlq, _ = jtfm.decode_step(jparams, jnp.asarray(nxt.numpy()), jnp.int32(s), jcache, jcfgq)
    assert rel_to_max(lq.numpy(), jlq) <= 1e-4


def test_serve_with_int8_cache_matches_reference_loop(llama):
    cfg, params, jcfg, jparams, toks = llama
    cfgq, jcfgq = (dataclasses.replace(c, kv_quant=True) for c in (cfg, jcfg))
    gen = 5
    got, t = serve(cfgq, params, torch.from_numpy(toks), gen)
    assert t["decode_steps"] == gen - 1
    s = toks.shape[1]
    jlast, jkv = jtfm.prefill(jparams, jnp.asarray(toks), jcfg)
    jcache = tuple(jax.lax.dynamic_update_slice(c, x, (0,) * c.ndim) for c, x in
                   zip(jtfm.init_kv_cache_int8(jcfgq, 2, s + gen),
                       jattn.quantize_kv_token(jkv[0], jkv[1])))
    tok = jnp.argmax(jlast, -1).astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        logits, jcache = jtfm.decode_step(jparams, tok, jnp.int32(s + i), jcache, jcfgq)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(tok)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.stack(want, axis=1)))
