"""deepseek-coder-33b [arXiv:2401.14196]: 62L, d=7168, 56H (kv=8), dense llama arch."""
from repro_torch.models.transformer import TransformerConfig

from .lm_common import LM_SHAPES, build_lm_dryrun, lm_smoke_config

ARCH_ID = "deepseek-coder-33b"
FAMILY = "lm"
SHAPES = tuple(LM_SHAPES)
MICRO_TARGET = 1  # 33B dense: one 4k sequence per device per micro-step


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH_ID,
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=19200,
        vocab_size=32256,
    )


def smoke_config() -> TransformerConfig:
    return lm_smoke_config(full_config())


def build_dryrun(shape: str, mesh, variant: str = "baseline"):
    return build_lm_dryrun(full_config(), shape, mesh, MICRO_TARGET, variant=variant)
