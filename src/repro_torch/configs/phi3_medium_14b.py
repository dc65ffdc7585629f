"""phi3-medium-14b — dense RoPE SwiGLU GQA kv=10. [arXiv:2404.14219]"""
from ..models.base import ModelConfig

ARCH_ID = "phi3-medium-14b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=10, d_ff=17920, vocab=100352,
        act="swiglu",
        source="arXiv:2404.14219")
