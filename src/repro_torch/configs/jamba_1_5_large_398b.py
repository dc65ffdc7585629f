"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
every other layer. [arXiv:2403.19887]

The Mamba sub-layers use the SSD mixer (the reference's adaptation)
with state 128 / head_dim 64 rather than Mamba-1's N=16 scalar
recurrence."""
from ..models.base import ModelConfig

ARCH_ID = "jamba-1.5-large-398b"

# one period: 8 sub-layers, attention at index 4, MoE every other FFN
PATTERN = (("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
           ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe"),
           ("mamba", "mlp"), ("mamba", "moe"))


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="hybrid", n_layers=72, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=24576, vocab=65536,
        head_dim=128, n_experts=16, top_k=2, block_pattern=PATTERN,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
        ssm_chunk=256, ssm_groups=8,
        source="arXiv:2403.19887")
