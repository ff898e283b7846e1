"""OLMoE-1B-7B [arXiv:2409.02060]: 16L, d=2048, 16H (kv=16), MoE 64e top-8."""
from repro_torch.models.transformer import TransformerConfig

from .lm_common import LM_SHAPES, build_lm_dryrun, lm_smoke_config

ARCH_ID = "olmoe-1b-7b"
FAMILY = "lm"
SHAPES = tuple(LM_SHAPES)
MICRO_TARGET = 4


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        n_experts=64,
        top_k=8,
    )


def smoke_config() -> TransformerConfig:
    return lm_smoke_config(full_config())


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    return build_lm_dryrun(full_config(), shape, mesh, MICRO_TARGET, variant=variant)
