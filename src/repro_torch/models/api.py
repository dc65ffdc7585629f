"""Uniform model API across all architecture families (mirrors
``repro/models/api.py``).

``batch`` dicts carry ``tokens`` (B, S) int, always; a VLM's also carry
``patches`` (B, P, D), the stub vision tower's patch features, and an
audio model's ``frames`` (B, F, D), the stub conv frontend's frame
embeddings.  A key the architecture does not take raises.
"""
from __future__ import annotations

import torch

from ..device import resolve_device
from . import encdec as ED
from . import transformer as T
from .base import ModelConfig
from .shardctx import current_plan


def _check_plan(cfg: ModelConfig, prefill: bool = False) -> None:
    """Under a tensor-parallel plan every family decodes (a Mamba2 mixer
    the rules would cut inside a head raises the plan's `check_family`
    error), and nothing prefills yet."""
    plan = current_plan()
    if plan is None:
        return
    plan.check_family(cfg)
    if prefill:
        raise NotImplementedError(
            f"{cfg.name}: prefill under a tensor-parallel plan is queued "
            f"(ROADMAP, Queue 1: serving under a plan); the decode step "
            f"runs under one")


def _check_inputs(cfg: ModelConfig, batch: dict) -> None:
    takes = {"tokens"} | {"vlm": {"patches"}, "audio": {"frames"}}.get(
        cfg.arch_type, set())
    if set(batch) - takes:
        raise ValueError(f"{cfg.name} ({cfg.arch_type}) takes the batch keys "
                         f"{sorted(takes)}, got {sorted(batch)}")


def model_init(cfg: ModelConfig, gen: torch.Generator,
               device="cuda") -> dict:
    """Random parameters drawn from ``gen``, which must live on ``device``.
    Runs on the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    if cfg.arch_type == "audio":
        return ED.init_encdec(cfg, gen, device)
    return T.init_lm(cfg, gen, device)


def model_logits(cfg: ModelConfig, params: dict, batch: dict,
                 use_ssd_kernel: bool = True):
    """Full-sequence logits of the text tokens and the aux loss (the MoE
    FFNs' load-balance loss summed over the layers; zero without one).
    ``use_ssd_kernel=False`` takes the differentiable SSD route (training),
    where the backward recomputes each block."""
    _check_inputs(cfg, batch)
    if cfg.arch_type == "audio":
        return ED.encdec_lm_logits(cfg, params, batch["tokens"],
                                   batch["frames"])
    return T.lm_logits(cfg, params, batch["tokens"], use_ssd_kernel,
                       extra_embeds=batch.get("patches"))


def model_init_cache(cfg: ModelConfig, params: dict, batch_size: int,
                     seq_len: int, batch: dict | None = None) -> dict:
    """An empty decode cache for ``seq_len`` positions (it sizes the
    attention ring buffers) on the parameters' device; an audio model's
    also holds the cross keys and values of ``batch["frames"]``.  Under a
    tensor-parallel plan it is this rank's part under
    `launch.sharding.cache_specs`."""
    _check_plan(cfg)
    if cfg.arch_type == "audio":
        return ED.encdec_init_cache(cfg, params, batch_size, seq_len,
                                    batch["frames"])
    return T.init_cache(cfg, batch_size, seq_len,
                        params["embed/tok"].device)


def model_decode_step(cfg: ModelConfig, params: dict, cache: dict,
                      token: torch.Tensor, pos, seq_len: int | None = None):
    """One decode step at each row's position ``pos`` ((B,) or a scalar);
    writes ``cache`` in place (see `transformer.decode_step` and
    `encdec.encdec_decode_step`, also for the step under a tensor-parallel
    plan, which needs the ``seq_len`` given to `model_init_cache` where the
    model has attention)."""
    _check_plan(cfg)
    if cfg.arch_type == "audio":
        return ED.encdec_decode_step(cfg, params, cache, token, pos, seq_len)
    return T.decode_step(cfg, params, cache, token, pos, seq_len)


def model_prefill(cfg: ModelConfig, params: dict, batch: dict,
                  seq_len: int | None = None):
    """(last-token logits (B, V), decode cache) of the prompt.  A VLM's
    patches take the first positions (its decode starts at S +
    n_patches); an audio model's decoder rings hold the prompt's keys and
    values, so its decode continues the teacher-forced decoder (the
    reference leaves them empty: ROADMAP, deviation 16)."""
    _check_inputs(cfg, batch)
    _check_plan(cfg, prefill=True)
    if cfg.arch_type == "audio":
        with torch.no_grad():
            enc_out = ED.encode(cfg, params, batch["frames"])
            return ED.decoder_prefill(cfg, params, batch["tokens"], enc_out,
                                      seq_len)
    return T.prefill(cfg, params, batch["tokens"], seq_len,
                     extra_embeds=batch.get("patches"))
