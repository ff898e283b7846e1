"""Card-only checks of the training path's attention (no JAX here).

* ``ops.attention`` on CUDA tensors that need a gradient runs the
  ``KernelAttention`` Function (the kernel forward, the plain backward);
  its output and dq, dk, dv are held against autograd through the plain
  version on the same card: f32 within 1e-4 of each tensor's max (TF32
  off), bf16 within 3e-2.
* Head dim 16 (the smoke configs') runs the f32 kernel, within 2e-5 of
  the plain version; bf16 at head dim 16 is refused.

Each test skips where ``torch.cuda.is_available()`` is false;
``python -m pytest -m cuda tests/test_torch_*.py`` runs them on a card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import launches, ops  # noqa: E402
from repro_torch.models.attention import flash_attention_torch  # noqa: E402

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these checks on one)")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def inputs(seed, shapes, dtype):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=s).astype(np.float32)).to("cuda", dtype)
            for s in shapes]


def fwd_bwd(fn, q, k, v, grad_out):
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves)
    return [out.detach(), *torch.autograd.grad(out, leaves, grad_out)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,hq,hkv,s,d", [
    (torch.float32, 2, 4, 2, 96, 16),      # the smoke configs' head dim
    (torch.float32, 1, 12, 2, 256, 128),
    (torch.bfloat16, 1, 12, 2, 256, 128),  # qwen2-1.5b's heads
])
def test_kernel_function_matches_plain_autograd(card, dtype, b, hq, hkv, s, d):
    q, k, v, g = inputs(0, [(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d)], dtype)
    n0 = launches["flash_attention"]
    got = fwd_bwd(lambda *t: ops.attention(*t, causal=True), q, k, v, g)
    assert launches["flash_attention"] == n0 + 1
    want = fwd_bwd(lambda *t: flash_attention_torch(*t, causal=True), q, k, v, g)
    for a, w in zip(got, want):
        err = float((a.float() - w.float()).abs().max() / w.float().abs().max())
        assert err <= TOL[dtype], err


@pytest.mark.cuda
def test_f32_head_dim_16_matches_plain(card):
    for causal, (sq, skv) in ((True, (24, 24)), (False, (100, 160)), (True, (200, 200))):
        q, k, v = inputs(1, [(2, 4, sq, 16), (2, 2, skv, 16), (2, 2, skv, 16)], torch.float32)
        got = fa.flash_attention_cuda(q, k, v, causal=causal)
        want = flash_attention_torch(q, k, v, causal=causal)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
def test_bf16_head_dim_16_is_refused(card):
    q, k, v = inputs(2, [(1, 4, 32, 16)] * 3, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_attention_cuda(q, k, v)
