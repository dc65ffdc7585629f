"""gemma-7b — dense, GeGLU, head_dim=256 (16H MHA). [arXiv:2403.08295]"""
from ..models.base import ModelConfig

ARCH_ID = "gemma-7b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense", n_layers=28, d_model=3072,
        n_heads=16, n_kv_heads=16, d_ff=24576, vocab=256000,
        head_dim=256, act="geglu",
        source="arXiv:2403.08295")
