"""llama3.2-3b [hf:meta-llama]: 28L, d=3072, 24H (kv=8), dense, vocab 128256."""
from repro_torch.models.transformer import TransformerConfig

from .lm_common import LM_SHAPES, build_lm_dryrun, lm_smoke_config

ARCH_ID = "llama3.2-3b"
FAMILY = "lm"
SHAPES = tuple(LM_SHAPES)
MICRO_TARGET = 2


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500000.0,
    )


def smoke_config() -> TransformerConfig:
    return lm_smoke_config(full_config())


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    return build_lm_dryrun(full_config(), shape, mesh, MICRO_TARGET, variant=variant)
