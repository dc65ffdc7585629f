"""Primitive layers (mirrors ``repro/models/layers.py``, the parts the
Mamba2 slice runs): init, RMSNorm, embeddings.

Parameters are flat dicts of tensors.  Matmul inputs stay in ``cfg.dtype``
(bf16 at full width) with fp32 normalization statistics, as in the
reference.  The MLP and RoPE come with the attention slice.
"""
from __future__ import annotations

import torch

from .base import ModelConfig

F32 = torch.float32


def _init(gen: torch.Generator, shape, scale, dtype,
          device) -> torch.Tensor:
    """Normal(0, 1) * scale drawn in fp32 from ``gen``, cast to ``dtype``."""
    return (torch.randn(shape, generator=gen, device=device, dtype=F32)
            * scale).to(dtype)


def sub(params: dict, prefix: str) -> dict:
    """The leaves under ``prefix/`` with the prefix taken off the names."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


# ----------------------------------------------------------------- norms ----
def init_rmsnorm(d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=F32, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"]
    return out.to(x.dtype)


# ------------------------------------------------------------ embeddings ----
def init_embed(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    V = cfg.eff_vocab
    p = {"tok": _init(gen, (V, cfg.d_model), 1.0, cfg.cdtype, device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _init(gen, (cfg.d_model, V), cfg.d_model ** -0.5,
                             cfg.cdtype, device)
    return p


def embed(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens].to(cfg.cdtype)


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    w = p["unembed"] if "unembed" in p else p["tok"].T
    logits = x @ w
    if cfg.eff_vocab != cfg.vocab:      # mask padded vocab columns
        mask = torch.arange(cfg.eff_vocab, device=logits.device) < cfg.vocab
        logits = torch.where(mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=logits.device))
    return logits
