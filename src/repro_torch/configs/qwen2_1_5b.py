"""qwen2-1.5b [arXiv:2407.10671]: 28L, d=1536, 12H (kv=2), QKV bias, vocab 151936."""
from repro_torch.models.transformer import TransformerConfig

from .lm_common import LM_SHAPES, build_lm_dryrun, lm_smoke_config

ARCH_ID = "qwen2-1.5b"
FAMILY = "lm"
SHAPES = tuple(LM_SHAPES)
MICRO_TARGET = 4


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1000000.0,
    )


def smoke_config() -> TransformerConfig:
    return lm_smoke_config(full_config())


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    return build_lm_dryrun(full_config(), shape, mesh, MICRO_TARGET, variant=variant)
