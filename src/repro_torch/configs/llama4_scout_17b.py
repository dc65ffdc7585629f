"""llama4-scout-17b-a16e — MoE 16 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from ..models.base import ModelConfig

ARCH_ID = "llama4-scout-17b-a16e"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="moe", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
        head_dim=128, n_experts=16, top_k=1, rope_theta=5e5,
        source="hf:meta-llama/Llama-4-Scout-17B-16E")
