"""Decoder stack (mirrors ``repro/models/transformer.py``), for the block
patterns whose sub-layers the port has: ``("mamba", "none")``.

A model is ``cfg.n_blocks`` repetitions of ``cfg.pattern``.  Block
parameters keep the reference's stacked leading ``n_blocks`` axis
(``blocks/s0_mix/w_z`` is (n_blocks, d_model, d_inner)); the passes loop
over it in Python where the reference runs ``lax.scan``.

Execution modes:
  * ``lm_logits``    - full-sequence logits
  * ``prefill``      - full-sequence forward that also builds the decode cache
  * ``decode_step``  - one token against the O(1) SSM state

Every Mamba mixer's within-chunk block goes through K5
(`kernels.ops.ssd_chunk`, its plain version on CPU tensors) unless
``use_ssd_kernel=False`` asks for the differentiable `ssm._chunk_local`,
the reference's switch (training runs that route: K5 has no backward).
Where autograd records, each block is a checkpoint
(``torch.utils.checkpoint``, the reference's ``remat``): the backward
recomputes it.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .base import ModelConfig
from .layers import embed, init_embed, init_rmsnorm, rmsnorm, sub, unembed
from .ssm import init_mamba, init_ssm_cache, mamba_decode_step, mamba_forward

_LATER = {"attn": "the attention mixer", "mlp": "the MLP FFN",
          "moe": "the MoE FFN"}


def _check_pattern(cfg: ModelConfig) -> None:
    for mixer, ffn in cfg.pattern:
        for part in (mixer, ffn):
            if part in _LATER:
                raise NotImplementedError(
                    f"{cfg.name}: {_LATER[part]} is not ported yet (a later "
                    f"slice of the port); this slice runs the "
                    f"('mamba', 'none') pattern")


def _block(params: dict, i: int) -> dict:
    """Block ``i`` of the stacked ``blocks/...`` leaves (views, no copy),
    named ``s0_mix/w_z`` and so on.  Any leaf indexable by block works: a
    (n_blocks, ...) tensor or a list of per-block tensors."""
    return {k[len("blocks/"):]: v[i] for k, v in params.items()
            if k.startswith("blocks/")}


# ------------------------------------------------------------------- init ----
def init_lm(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Flat parameters: ``embed/tok``, ``blocks/s{i}_n1/scale``,
    ``blocks/s{i}_mix/<leaf>`` with the leading n_blocks axis, and
    ``final_norm/scale``."""
    _check_pattern(cfg)
    nb = cfg.n_blocks
    params = {f"embed/{k}": v for k, v in init_embed(gen, cfg, device).items()}
    for i in range(len(cfg.pattern)):
        params[f"blocks/s{i}_n1/scale"] = torch.ones(
            (nb, cfg.d_model), dtype=torch.float32, device=device)
        for k, v in init_mamba(gen, cfg, device, n_blocks=nb).items():
            params[f"blocks/s{i}_mix/{k}"] = v
    params["final_norm/scale"] = init_rmsnorm(cfg.d_model, device)["scale"]
    return params


# --------------------------------------------------------------- forward ----
def _block_forward(cfg: ModelConfig, bp: dict, x: torch.Tensor,
                   use_ssd_kernel: bool = True):
    """One pattern-repeat in full-sequence mode.  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, _ in enumerate(cfg.pattern):
        h = rmsnorm(sub(bp, f"s{i}_n1"), x, cfg.norm_eps)
        out = mamba_forward(sub(bp, f"s{i}_mix"), cfg, h,
                            use_ssd_kernel=use_ssd_kernel)
        x = x + out
    return x, aux


def backbone(cfg: ModelConfig, params: dict, x: torch.Tensor,
             use_ssd_kernel: bool = True):
    """Run the block stack on embeddings x: (B, S, D).  With autograd
    recording, each block is a checkpoint: the backward keeps only the
    blocks' inputs and recomputes one block at a time."""
    _check_pattern(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = torch.is_grad_enabled()
    for b in range(cfg.n_blocks):
        bp = _block(params, b)
        if ckpt:
            x, a = checkpoint(lambda h, bp=bp: _block_forward(
                cfg, bp, h, use_ssd_kernel), x, use_reentrant=False)
        else:
            x, a = _block_forward(cfg, bp, x, use_ssd_kernel)
        aux = aux + a
    return x, aux


def embed_inputs(cfg: ModelConfig, params: dict,
                 tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding (the VLM patch prefix comes with a later slice)."""
    return embed(sub(params, "embed"), cfg, tokens)


def lm_logits(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
              use_ssd_kernel: bool = True):
    """Full-sequence logits (B, S, V) and the aux loss."""
    x = embed_inputs(cfg, params, tokens)
    x, aux = backbone(cfg, params, x, use_ssd_kernel)
    x = rmsnorm(sub(params, "final_norm"), x, cfg.norm_eps)
    return unembed(sub(params, "embed"), cfg, x), aux


# ----------------------------------------------------------------- decode ----
def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """Decode cache: the O(1) SSM state and conv windows of every Mamba
    sub-layer, ``s{i}/<leaf>`` with the leading n_blocks axis.  ``seq_len``
    sizes attention ring buffers, which this slice does not have."""
    _check_pattern(cfg)
    del seq_len
    cache = {}
    for i in range(len(cfg.pattern)):
        for k, v in init_ssm_cache(cfg, batch, device).items():
            cache[f"s{i}/{k}"] = v[None].expand(
                (cfg.n_blocks,) + tuple(v.shape)).contiguous()
    return cache


def _block_decode(cfg: ModelConfig, bp: dict, bc: dict, x: torch.Tensor):
    new_cache = {}
    for i, _ in enumerate(cfg.pattern):
        h = rmsnorm(sub(bp, f"s{i}_n1"), x, cfg.norm_eps)
        out, nc = mamba_decode_step(sub(bp, f"s{i}_mix"), cfg, h,
                                    sub(bc, f"s{i}"))
        new_cache.update({f"s{i}/{k}": v for k, v in nc.items()})
        x = x + out
    return x, new_cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) int; ``pos`` is the position the
    attention sub-layers would read (Mamba reads none).  Returns
    (logits (B, V), new cache); the cache passed in is not written."""
    del pos
    x = embed(sub(params, "embed"), cfg, token[:, None])
    new_cache = {k: torch.empty_like(v) for k, v in cache.items()}
    for b in range(cfg.n_blocks):
        x, nc = _block_decode(cfg, _block(params, b),
                              {k: v[b] for k, v in cache.items()}, x)
        for k, v in nc.items():
            new_cache[k][b] = v
    x = rmsnorm(sub(params, "final_norm"), x, cfg.norm_eps)
    return unembed(sub(params, "embed"), cfg, x)[:, 0], new_cache


# ---------------------------------------------------------------- prefill ----
def _block_prefill(cfg: ModelConfig, bp: dict, x: torch.Tensor):
    """Full-seq forward that also emits this block's decode cache."""
    cache = {}
    for i, _ in enumerate(cfg.pattern):
        h = rmsnorm(sub(bp, f"s{i}_n1"), x, cfg.norm_eps)
        out, c = mamba_forward(sub(bp, f"s{i}_mix"), cfg, h,
                               return_cache=True)
        cache.update({f"s{i}/{k}": v for k, v in c.items()})
        x = x + out
    return x, cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            seq_len: int | None = None):
    """Prefill: returns (last-token logits (B, V), decode cache)."""
    _check_pattern(cfg)
    del seq_len                     # sizes attention caches only
    x = embed_inputs(cfg, params, tokens)
    caches = []
    for b in range(cfg.n_blocks):
        x, c = _block_prefill(cfg, _block(params, b), x)
        caches.append(c)
    cache = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    x = rmsnorm(sub(params, "final_norm"), x[:, -1:], cfg.norm_eps)
    return unembed(sub(params, "embed"), cfg, x)[:, 0], cache
