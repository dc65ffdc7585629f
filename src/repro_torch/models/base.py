"""Model configuration language (mirrors ``repro/models/base.py``).

One frozen dataclass describes every architecture family (dense, moe, ssm,
hybrid, vlm, audio).  A model is a repeated ``block_pattern``: each entry is
a ``(mixer, ffn)`` pair with ``mixer in {"attn", "mamba"}`` and
``ffn in {"mlp", "moe", "none"}``.  Dense archs use ``[("attn", "mlp")]``,
Mamba2 uses ``[("mamba", "none")]``, Jamba interleaves, etc.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

Pattern = tuple[tuple[str, str], ...]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int               # total sub-layers (= n_blocks * len(pattern))
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int | None = None          # default: d_model // n_heads
    pad_heads: int = 0       # pad MHA head count; extra heads masked to zero
    pad_vocab: int = 0       # pad embedding/logit vocab; padded logits masked
    qkv_bias: bool = False
    act: str = "swiglu"                  # swiglu | geglu | gelu
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"              # rope | learned (whisper)
    max_seq: int = 32_768
    sliding_window: int | None = None    # attention window; None = full causal
    tie_embeddings: bool = True

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 256

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # --- hybrid pattern ---
    block_pattern: Pattern = ()          # empty => derived from arch_type

    # --- modality frontends ---
    n_patches: int = 0
    n_audio_frames: int = 0
    enc_layers: int = 0

    dtype: str = "bfloat16"
    source: str = ""

    # ----- derived -----
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def eff_heads(self) -> int:
        return self.pad_heads or self.n_heads

    @property
    def eff_kv_heads(self) -> int:
        if self.pad_heads and self.n_kv_heads == self.n_heads:
            return self.pad_heads
        return self.n_kv_heads

    @property
    def eff_vocab(self) -> int:
        return self.pad_vocab or self.vocab

    @property
    def pattern(self) -> Pattern:
        if self.block_pattern:
            return self.block_pattern
        if self.arch_type == "ssm":
            return (("mamba", "none"),)
        return (("attn", "moe" if self.n_experts else "mlp"),)

    @property
    def n_blocks(self) -> int:
        p = self.pattern
        if self.n_layers % len(p):
            raise ValueError(f"{self.name}: n_layers={self.n_layers} is not a "
                             f"multiple of the pattern length {len(p)}")
        return self.n_layers // len(p)

    @property
    def d_inner(self) -> int:            # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Reduced variant for CPU smoke tests: same family / pattern semantics,
    # 2 pattern-repeats, tiny dims, <=4 experts (the reference's own).
    def smoke(self) -> "ModelConfig":
        p = self.pattern
        kv = min(self.n_kv_heads, 4)
        if kv:
            nh = max(kv, min(self.n_heads, 4))
            nh = (nh // kv) * kv or kv
        else:
            nh = 0
        return self.replace(
            n_layers=2 * len(p),
            d_model=128,
            n_heads=nh,
            n_kv_heads=kv,
            head_dim=32 if self.head_dim else None,
            d_ff=256,
            vocab=max(self.vocab and 512, 512),
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 32),
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=16,
            max_seq=256,
            sliding_window=None,
            n_patches=min(self.n_patches, 16),
            n_audio_frames=min(self.n_audio_frames, 32),
            enc_layers=min(self.enc_layers, 2),
            moe_group_size=16,
            dtype="float32",
        )


def param_count(params: dict) -> int:
    """Values in a flat parameter dict."""
    return sum(int(v.numel()) for v in params.values())
