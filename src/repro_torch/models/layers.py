"""Primitive layers (mirrors ``repro/models/layers.py``): init, RMSNorm,
MLPs, RoPE, embeddings.

Parameters are flat dicts of tensors.  Matmul inputs stay in ``cfg.dtype``
(bf16 at full width) with fp32 normalization statistics and RoPE angles, as
in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .shardctx import copy_to_model, current_plan, reduce_model
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


# ------------------------------------------------------------------ MLPs ----
def init_mlp(gen: torch.Generator, cfg: ModelConfig, device,
             n_blocks: int | None = None) -> dict:
    """One MLP's parameters; with ``n_blocks`` every leaf gets that leading
    axis (the stacked block layout)."""
    d, f = cfg.d_model, cfg.d_ff
    lead = () if n_blocks is None else (n_blocks,)
    s_in, s_out = d ** -0.5, f ** -0.5

    def normal(shape, scale):
        return _init(gen, lead + shape, scale, cfg.cdtype, device)

    p = {"w_down": normal((f, d), s_out)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = normal((d, f), s_in)
        p["w_up"] = normal((d, f), s_in)
    else:  # gelu
        p["w_up"] = normal((d, f), s_in)
        p["b_up"] = torch.zeros(lead + (f,), dtype=cfg.cdtype, device=device)
        p["b_down"] = torch.zeros(lead + (d,), dtype=cfg.cdtype,
                                  device=device)
    return p


def mlp(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Under a tensor-parallel plan (`shardctx.current_plan`) that splits
    d_ff: column-parallel in, row-parallel out, the partial sums
    all-reduced over "model" before ``b_down``."""
    plan = current_plan()
    split = plan is not None and plan.mlp_tp
    if split:
        x = copy_to_model(plan, x)
    if cfg.act == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif cfg.act == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])
    else:
        h = F.gelu(x @ p["w_up"] + p["b_up"], approximate="tanh")
    out = h @ p["w_down"]
    if split:
        out = reduce_model(plan, out)
    if "b_down" in p:
        out = out + p["b_down"]
    return out


# ------------------------------------------------------------------ RoPE ----
def rope_freqs(cfg: ModelConfig, positions: torch.Tensor):
    """positions: (...,) int -> cos/sin of shape (..., hd/2) in fp32."""
    hd = cfg.hd
    inv = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, hd, 2, dtype=F32, device=positions.device) / hd))
    ang = positions.to(F32)[..., None] * inv                 # (..., hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (S, hd/2) or (B, S, hd/2).  The rotation
    of the two halves is computed in fp32 and cast back to x's dtype."""
    xf = x.to(F32)
    x1, x2 = xf.chunk(2, dim=-1)
    if cos.dim() == 2:                      # (S, hd/2) -> over B and H
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:                                   # (B, S, hd/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
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
    """Under a tensor-parallel plan (`shardctx.current_plan`) that splits
    the vocabulary, ``tok`` holds the rank's rows: a token outside them
    looks up zeros and the rows are summed over "model"."""
    plan = current_plan()
    if plan is None or not plan.vocab_tp:
        return p["tok"][tokens].to(cfg.cdtype)
    n = p["tok"].shape[0]
    local = tokens - plan.vocab_start(n)
    inside = (local >= 0) & (local < n)
    rows = p["tok"][local.clamp(0, n - 1)].to(cfg.cdtype)
    return reduce_model(plan, torch.where(inside[..., None], rows,
                                         torch.zeros_like(rows)))


def unembed(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits; under a tensor-parallel plan that splits the vocabulary, the
    rank's columns (column-parallel)."""
    w = p["unembed"] if "unembed" in p else p["tok"].T
    plan = current_plan()
    lo = 0
    if plan is not None and plan.vocab_tp:
        x, lo = copy_to_model(plan, x), plan.vocab_start(w.shape[1])
    logits = x @ w
    if cfg.eff_vocab != cfg.vocab:      # mask padded vocab columns
        mask = torch.arange(lo, lo + w.shape[1],
                            device=logits.device) < cfg.vocab
        logits = torch.where(mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype,
                                          device=logits.device))
    return logits
