"""qwen1.5-110b — dense 80L, GQA kv=8, QKV bias. [hf:Qwen/Qwen1.5-0.5B family]"""
from ..models.base import ModelConfig

ARCH_ID = "qwen1.5-110b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=49152, vocab=152064,
        head_dim=128, qkv_bias=True, act="swiglu", rope_theta=1e6,
        source="hf:Qwen/Qwen1.5-0.5B")
