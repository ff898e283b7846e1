"""granite-moe-3b-a800m [hf:ibm-granite]: 32L, d=1536, 24H (kv=8), MoE 40e top-8."""
from repro_torch.models.transformer import TransformerConfig

from .lm_common import LM_SHAPES, build_lm_dryrun, lm_smoke_config

ARCH_ID = "granite-moe-3b-a800m"
FAMILY = "lm"
SHAPES = tuple(LM_SHAPES)
MICRO_TARGET = 4


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        n_experts=40,
        top_k=8,
    )


def smoke_config() -> TransformerConfig:
    return lm_smoke_config(full_config())


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    return build_lm_dryrun(full_config(), shape, mesh, MICRO_TARGET, variant=variant)
