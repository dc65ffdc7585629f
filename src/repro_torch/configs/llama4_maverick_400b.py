"""llama4-maverick-400b-a17b — MoE 128 experts top-1, early fusion.
Dense and MoE layers alternate (that is what makes the 48L/128e/d_ff-8192
spec total ~400B rather than ~774B — matching the model card).
[hf:meta-llama/Llama-4-Scout-17B-16E family]"""
from ..models.base import ModelConfig

ARCH_ID = "llama4-maverick-400b-a17b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="moe", n_layers=48, d_model=5120,
        n_heads=40, n_kv_heads=8, d_ff=8192, vocab=202048,
        head_dim=128, n_experts=128, top_k=1, rope_theta=5e5,
        block_pattern=(("attn", "mlp"), ("attn", "moe")),
        source="hf:meta-llama/Llama-4-Scout-17B-16E")
