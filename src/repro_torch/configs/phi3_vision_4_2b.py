"""phi-3-vision-4.2b — phi3-mini LM + CLIP patch-embed stub (576 patches).
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from ..models.base import ModelConfig

ARCH_ID = "phi-3-vision-4.2b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="vlm", n_layers=32, d_model=3072,
        n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064,
        n_patches=576, act="swiglu",
        source="hf:microsoft/Phi-3-vision-128k-instruct")
