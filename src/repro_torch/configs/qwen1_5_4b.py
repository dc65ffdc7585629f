"""qwen1.5-4b — dense 40L, GQA kv=20, QKV bias. [hf:Qwen/Qwen1.5-0.5B family]"""
from ..models.base import ModelConfig

ARCH_ID = "qwen1.5-4b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="dense", n_layers=40, d_model=2560,
        n_heads=20, n_kv_heads=20, d_ff=6912, vocab=151936,
        head_dim=128, qkv_bias=True, act="swiglu", rope_theta=1e6,
        source="hf:Qwen/Qwen1.5-0.5B")
