"""Uniform model API (mirrors ``repro/models/api.py``), token-only
architectures: the dense family, Mamba2, the MoE models (llama4) and the
Mamba-attention-MoE hybrid (Jamba).

``batch`` dicts carry ``tokens`` (B, S) int.  The audio (encoder-decoder)
and VLM (patch prefix) branches come with a later slice and raise.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import transformer as T
from .base import ModelConfig


def _token_only(cfg: ModelConfig, batch: dict | None = None) -> None:
    if cfg.arch_type in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.arch_type} model is not ported yet (a "
            f"later slice of the port); token-only architectures run")
    if batch is not None and set(batch) - {"tokens"}:
        raise NotImplementedError(
            f"only token inputs are ported, got {sorted(batch)}")


def model_init(cfg: ModelConfig, gen: torch.Generator,
               device="cuda") -> dict:
    """Random parameters drawn from ``gen``, which must live on ``device``.
    Runs on the card unless the caller asks for the CPU."""
    _token_only(cfg)
    return T.init_lm(cfg, gen, resolve_device(device))


def model_logits(cfg: ModelConfig, params: dict, batch: dict,
                 use_ssd_kernel: bool = True):
    """Full-sequence logits and the aux loss (the MoE FFNs' load-balance
    loss summed over the layers; zero without one).
    ``use_ssd_kernel=False`` takes the differentiable SSD route (training),
    where the backward recomputes each block."""
    _token_only(cfg, batch)
    return T.lm_logits(cfg, params, batch["tokens"], use_ssd_kernel)


def model_init_cache(cfg: ModelConfig, params: dict, batch_size: int,
                     seq_len: int) -> dict:
    """An empty decode cache for ``seq_len`` positions (it sizes the
    attention ring buffers) on the parameters' device."""
    _token_only(cfg)
    return T.init_cache(cfg, batch_size, seq_len,
                        params["embed/tok"].device)


def model_decode_step(cfg: ModelConfig, params: dict, cache: dict,
                      token: torch.Tensor, pos):
    """One decode step at each row's position ``pos`` ((B,) or a scalar);
    writes ``cache`` in place (see `transformer.decode_step`)."""
    _token_only(cfg)
    return T.decode_step(cfg, params, cache, token, pos)


def model_prefill(cfg: ModelConfig, params: dict, batch: dict,
                  seq_len: int | None = None):
    _token_only(cfg, batch)
    return T.prefill(cfg, params, batch["tokens"], seq_len)
