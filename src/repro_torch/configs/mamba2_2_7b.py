"""mamba2-2.7b — attention-free SSD (state-space duality). [arXiv:2405.21060]"""
from ..models.base import ModelConfig

ARCH_ID = "mamba2-2.7b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        ssm_chunk=256, ssm_groups=1, tie_embeddings=True,
        source="arXiv:2405.21060")
