"""Port parity: attention of ``repro_torch`` against the JAX package.

The port's plain blockwise attention (``ops.attention`` on CPU tensors and
``flash_attention_torch`` directly) is held against the reference's Pallas
kernel, run in interpret mode as the reference's own tests run it on the
CPU, and against the dense oracle ``attention_ref``; decode attention
against the reference's ``decode_attention``.  Inputs are made with numpy
from a fixed seed and handed to both packages.

Tolerances: 2e-5 (absolute and relative) in f32, as the reference's
kernel test — the two sum in different orders; 3e-2 in bf16, the
reference's bf16 tolerance.  The CUDA kernel itself runs only on a card
(``chip_smoke.py``, and the ``cuda``-marked test here).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.models.attention import decode_attention as jax_decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    decode_attention,
    decode_attention_int8,
    flash_attention_torch,
    quantize_kv_token,
)

# the reference's cases (tests/test_kernels_attention.py::CASES)
CASES = [
    (2, 4, 4, 128, 128, 64, True),
    (1, 8, 2, 256, 256, 128, True),   # GQA 4×
    (2, 4, 1, 64, 192, 32, False),    # MQA, non-divisible kv blocks
    (1, 2, 2, 100, 100, 64, True),    # ragged tiles
    (1, 4, 4, 96, 320, 64, True),     # kv longer than q (chunked prefill)
]
F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)
# the bf16 kernel against the exact (f32) result of its bf16 inputs, as the
# largest relative L2 error of one query row: it rounds P and O to bf16 only
BF16_ROW_REL_L2 = 1e-2


def qkv_np(rng, b, hq, hkv, sq, skv, d):
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def as_torch(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def as_jax(arrs, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrs]


def f32(x):
    return x.to(torch.float32).numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", CASES)
def test_plain_matches_pallas_and_ref(b, hq, hkv, sq, skv, d, causal, rng):
    arrs = qkv_np(rng, b, hq, hkv, sq, skv, d)
    q, k, v = as_torch(arrs)
    jq, jk, jv = as_jax(arrs)
    pallas = f32(flash_attention_pallas(jq, jk, jv, causal=causal, interpret=True))
    dense = f32(jax_attention_ref(jq, jk, jv, causal=causal))
    for got in (ops.attention(q, k, v, causal=causal),
                flash_attention_torch(q, k, v, causal=causal, block_k=64)):
        assert got.dtype == torch.float32 and got.shape == (b, hq, sq, d)
        np.testing.assert_allclose(f32(got), pallas, **F32)
        np.testing.assert_allclose(f32(got), dense, **F32)
    np.testing.assert_allclose(f32(ref.attention_ref(q, k, v, causal=causal)), dense, **F32)


@pytest.mark.parametrize("sm_scale", [0.3, 0.0, -0.2])
def test_plain_matches_pallas_at_any_scale(sm_scale, rng):
    """A zero or negative scale (uniform or reversed attention) as well: the
    reference takes any scale, and the card's kernels are held to this."""
    b, hq, hkv, sq, skv, d, causal = CASES[3]
    arrs = qkv_np(rng, b, hq, hkv, sq, skv, d)
    q, k, v = as_torch(arrs)
    jq, jk, jv = as_jax(arrs)
    pallas = f32(flash_attention_pallas(jq, jk, jv, causal=causal, sm_scale=sm_scale,
                                        interpret=True))
    dense = f32(jax_attention_ref(jq, jk, jv, causal=causal, sm_scale=sm_scale))
    got = f32(flash_attention_torch(q, k, v, causal=causal, sm_scale=sm_scale, block_k=64))
    np.testing.assert_allclose(got, pallas, **F32)
    np.testing.assert_allclose(got, dense, **F32)


def test_causal_more_queries_than_keys_gives_zero_rows(rng):
    """Sq > Skv under the causal mask: the first Sq − Skv query rows see no
    key.  The blockwise versions output exactly 0 there (the 1e-30 floor);
    the dense oracle outputs the mean of v, so the case is held against
    the Pallas kernel only."""
    arrs = qkv_np(rng, 2, 4, 2, 96, 64, 32)
    q, k, v = as_torch(arrs)
    pallas = f32(flash_attention_pallas(*as_jax(arrs), causal=True, interpret=True))
    for got in (ops.attention(q, k, v, causal=True),
                flash_attention_torch(q, k, v, causal=True, block_k=64)):
        np.testing.assert_allclose(f32(got), pallas, **F32)
        assert np.all(f32(got)[:, :, :32] == 0.0)
        assert np.all(np.abs(f32(got)[:, :, 32:]).sum(-1) > 0)
    assert np.all(pallas[:, :, :32] == 0.0)


def test_block_size_independence(rng):
    q, k, v = as_torch(qkv_np(rng, 1, 2, 2, 256, 256, 32))
    outs = [f32(flash_attention_torch(q, k, v, block_k=bk)) for bk in (64, 128, 256, 512)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, **F32)


def test_bf16_tolerance(rng):
    arrs = qkv_np(rng, 1, 4, 2, 128, 128, 64)
    q, k, v = as_torch(arrs, torch.bfloat16)
    jq, jk, jv = as_jax(arrs, jnp.bfloat16)
    got = ops.attention(q, k, v)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(jax_attention_ref(jq, jk, jv)), **BF16)
    np.testing.assert_allclose(f32(got), f32(flash_attention_pallas(jq, jk, jv, interpret=True)),
                               **BF16)


@pytest.mark.parametrize("cache_len", [96, 61, "per_row"])
def test_decode_matches_reference(cache_len, rng):
    b, hq, hkv, s, d = 2, 8, 2, 96, 64
    arrs = qkv_np(rng, b, hq, hkv, s, s, d)
    q, k, v = as_torch(arrs)
    jq, jk, jv = as_jax(arrs)
    lens = np.array([40, 96], np.int32) if cache_len == "per_row" else cache_len
    got = decode_attention(q[:, :, -1:], k, v, cache_len=torch.as_tensor(lens))
    want = jax_decode_attention(jq[:, :, -1:], jk, jv, cache_len=jnp.asarray(lens))
    np.testing.assert_allclose(f32(got), f32(want), **F32)


def test_decode_matches_last_row_of_prefill(rng):
    b, hq, hkv, s, d = 2, 8, 2, 96, 64
    q, k, v = as_torch(qkv_np(rng, b, hq, hkv, s, s, d))
    full = ops.attention(q, k, v, causal=True)
    dec = decode_attention(q[:, :, -1:], k, v, cache_len=s)
    np.testing.assert_allclose(f32(full[:, :, -1:]), f32(dec), **F32)


def test_int8_decode_is_not_ported(rng):
    """The int8 KV cache is ported: the reference's quantized cache (its
    bits equal to the port's) and the port's decode against the
    reference's, GQA 4x, within 1e-6 of the output's largest magnitude."""
    from repro.models.attention import decode_attention_int8 as jax_decode_int8
    from repro.models.attention import quantize_kv_token as jax_quantize

    q, k, v = qkv_np(rng, 1, 8, 2, 1, 40, 64)
    jcache = [np.array(x) for x in jax_quantize(jnp.asarray(k), jnp.asarray(v))]
    for got, want in zip(quantize_kv_token(torch.from_numpy(k), torch.from_numpy(v)), jcache):
        np.testing.assert_array_equal(got.numpy(), want)
    got = decode_attention_int8(torch.from_numpy(q), *map(torch.from_numpy, jcache), cache_len=40)
    want = np.asarray(jax_decode_int8(jnp.asarray(q), *map(jnp.asarray, jcache), cache_len=40))
    assert float(np.abs(got.numpy() - want).max()) <= 1e-6 * float(np.abs(want).max())


def test_cuda_paths_reject_cpu_tensors():
    q = torch.zeros((1, 2, 16, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.attention(q, q, q, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.attention(q, q, q, backend="pallas")


@pytest.mark.parametrize("block_q,block_k,sq,skv,want", [
    (64, 64, 2048, 2048, (64, 64)),
    (128, 256, 100, 100, (112, 128)),
    (16, 64, 5, 3, (16, 64)),
])
def test_block_sizes_are_cut_to_the_sequence(block_q, block_k, sq, skv, want):
    assert fa._blocks(block_q, block_k, sq, skv) == want


@pytest.mark.parametrize("block_q,block_k", [(8, 64), (144, 64), (64, 32), (64, 100)])
def test_block_sizes_outside_the_kernel_raise(block_q, block_k):
    with pytest.raises(ValueError, match="block_"):
        fa._blocks(block_q, block_k, 256, 256)


@pytest.mark.parametrize("block_q,block_k,sq,skv,want", [
    (None, None, 2048, 2048, (128, 128)),   # the bf16 default
    (64, 128, 2048, 2048, (64, 128)),
    (128, 64, 300, 77, (128, 64)),
    (128, 128, 64, 40, (64, 64)),           # one 64-row warpgroup and tile suffice
])
def test_bf16_block_sizes_are_cut_to_the_sequence(block_q, block_k, sq, skv, want):
    assert fa._blocks(block_q, block_k, sq, skv, torch.bfloat16) == want


@pytest.mark.parametrize("block_q,block_k", [(16, 64), (96, 128), (256, 128), (64, 32),
                                             (128, 192), (64, 256)])
def test_bf16_block_sizes_outside_the_kernel_raise(block_q, block_k):
    """The wgmma kernel takes 64 query rows per consumer warpgroup (one or
    two) and 64- or 128-key tiles; anything else is refused."""
    with pytest.raises(ValueError, match="block_"):
        fa._blocks(block_q, block_k, 256, 256, torch.bfloat16)


def test_f32_default_blocks_are_unchanged():
    assert fa._blocks(None, None, 2048, 2048, torch.float32) == (64, 64)
    assert fa.DEFAULT_BLOCKS[torch.bfloat16] == (128, 128)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_card(rng):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on one)")
    for b, hq, hkv, sq, skv, d, causal in CASES + [(2, 4, 2, 96, 64, 32, True)]:
        arrs = qkv_np(rng, b, hq, hkv, sq, skv, d)
        for dtype, tol in ((torch.float32, F32), (torch.bfloat16, BF16)):
            q, k, v = (t.cuda() for t in as_torch(arrs, dtype))
            got = fa.flash_attention_cuda(q, k, v, causal=causal)
            want = flash_attention_torch(q, k, v, causal=causal)
            np.testing.assert_allclose(f32(got.cpu()), f32(want.cpu()), **tol)
            if dtype == torch.bfloat16:
                for bq, bk in ((64, 64), (128, 64), (64, 128)):  # the other wgmma tiles
                    other = fa.flash_attention_cuda(q, k, v, causal=causal, block_q=bq,
                                                    block_k=bk)
                    np.testing.assert_allclose(f32(other.cpu()), f32(want.cpu()), **tol)
                exact = flash_attention_torch(q.float(), k.float(), v.float(), causal=causal)
                rows = (got.float() - exact).norm(dim=-1) / exact.norm(dim=-1).clamp_min(1e-6)
                assert float(rows.max()) <= BF16_ROW_REL_L2
            for scale in (0.3, 0.0, -0.2):  # any scale, as the reference takes
                got_s = fa.flash_attention_cuda(q, k, v, causal=causal, sm_scale=scale)
                if dtype == torch.float32:
                    want_s = flash_attention_torch(q, k, v, causal=causal, sm_scale=scale)
                    np.testing.assert_allclose(f32(got_s.cpu()), f32(want_s.cpu()), **tol)
                    continue
                # bf16 against the exact result: the plain bf16 version rounds
                # the scores to bf16, which at scale 0.3 errs past 3e-2 itself
                exact = flash_attention_torch(q.float(), k.float(), v.float(), causal=causal,
                                              sm_scale=scale)
                rows = (got_s.float() - exact).norm(dim=-1) / exact.norm(dim=-1).clamp_min(1e-6)
                assert float(rows.max()) <= BF16_ROW_REL_L2
