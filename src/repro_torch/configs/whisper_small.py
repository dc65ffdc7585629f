"""whisper-small — encoder-decoder, 12+12L; mel+conv frontend stubbed
(the launchers feed 1500 precomputed frame embeddings). [arXiv:2212.04356]"""
from ..models.base import ModelConfig

ARCH_ID = "whisper-small"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, arch_type="audio", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab=51865,
        enc_layers=12, n_audio_frames=1500, act="gelu",
        pos_embed="learned", tie_embeddings=True,
        source="arXiv:2212.04356")
