"""Decoder stack (mirrors ``repro/models/transformer.py``) for every
decoder-only block pattern: the attention and Mamba mixers, each followed
by an MLP, the MoE FFN or no FFN (the dense family's and the VLM's
``("attn", "mlp")``, Mamba2's ``("mamba", "none")``, llama4's MoE layers,
Jamba's period of 8).

A model is ``cfg.n_blocks`` repetitions of ``cfg.pattern``.  Block
parameters keep the reference's stacked leading ``n_blocks`` axis
(``blocks/s0_mix/wq`` is (n_blocks, d_model, heads * head_dim)); the
passes loop over it in Python where the reference runs ``lax.scan``.

A VLM (``cfg.n_patches``) also has ``patch_proj/w`` (d_model, d_model):
the projector of the stub vision tower's patch features, whose outputs
are prepended to the token embeddings (``extra_embeds``).

Execution modes:
  * ``lm_logits``    - full-sequence logits (a VLM's image positions
    dropped)
  * ``prefill``      - full-sequence forward that also builds the decode cache
  * ``decode_step``  - one token against a ring-buffer KV cache / SSM state,
    every row at its own position, the cache written in place

Every Mamba mixer's within-chunk block goes through K5
(`kernels.ops.ssd_chunk`, its plain version on CPU tensors) unless
``use_ssd_kernel=False`` asks for the differentiable `ssm._chunk_local`,
the reference's switch (training runs that route: K5 has no backward).
Attention, the MLP and the MoE FFN are plain PyTorch, as in the
reference.  Where autograd records, each block is a checkpoint
(``torch.utils.checkpoint``, the reference's ``remat``): the backward
recomputes it; in a pattern of more than one sub-layer each mixer and each
FFN is a checkpoint of its own inside it (the reference's
``sublayer_remat``), so the backward holds one sub-layer's intermediates.
The MoE FFN's load-balance loss is summed over the blocks in full-sequence
mode and dropped in prefill and decode, as in the reference.

Over a mesh that splits "data" or "model" (a plan in force:
`shardctx.active_plan`; each sub-layer runs its own part of the plan:
`attention`, `layers.mlp`, `ssm`, `moe`, and `embed_inputs` the VLM's
column-parallel projector),
``lm_logits`` gathers the leaves outside the stack over "data" once and
each block's inside its checkpoint (the recompute gathers again, whole:
no early stop), and returns the rank's vocabulary columns; ``decode_step``
gathers them the same way, runs against the rank's part of the cache
(`init_cache` lays it out by `sharding.cache_specs`) and returns whole
rows of the vocabulary.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .shardctx import (current_plan, gather_block, gather_columns,
                       gather_top, gather_vocab)

from .attention import (attn_decode_step, attn_forward, init_attn,
                        ring_layout)
from .base import ModelConfig
from .layers import (_init, embed, init_embed, init_mlp, init_rmsnorm, mlp,
                     rmsnorm, sub, unembed)
from .moe import init_moe, moe_ffn
from .ssm import (init_mamba, mamba_decode_step, mamba_forward,
                  ssm_cache_shapes)


def _block(params: dict, i: int, stack: str = "blocks") -> dict:
    """Block ``i`` of the stacked ``<stack>/...`` leaves (views, no copy),
    named ``s0_mix/w_z`` and so on (the encoder-decoder's stacks are
    ``enc`` and ``dec``).  Any leaf indexable by block works: a
    (n_blocks, ...) tensor or a list of per-block tensors."""
    n = len(stack) + 1
    return {k[n:]: v[i] for k, v in params.items()
            if k.startswith(stack + "/")}


# ------------------------------------------------------------------- init ----
def init_lm(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Flat parameters: ``embed/tok``, ``blocks/s{i}_n1/scale``,
    ``blocks/s{i}_mix/<leaf>`` (and ``blocks/s{i}_n2/scale``,
    ``blocks/s{i}_ffn/<leaf>`` where the pattern has an FFN) with the
    leading n_blocks axis, ``final_norm/scale`` and, for a VLM,
    ``patch_proj/w``."""
    nb = cfg.n_blocks
    params = {f"embed/{k}": v for k, v in init_embed(gen, cfg, device).items()}

    def norm(name):
        params[f"blocks/{name}/scale"] = torch.ones(
            (nb, cfg.d_model), dtype=torch.float32, device=device)

    for i, (mixer, ffn) in enumerate(cfg.pattern):
        norm(f"s{i}_n1")
        init_mix = init_attn if mixer == "attn" else init_mamba
        for k, v in init_mix(gen, cfg, device, n_blocks=nb).items():
            params[f"blocks/s{i}_mix/{k}"] = v
        if ffn != "none":
            norm(f"s{i}_n2")
            init_ffn = init_moe if ffn == "moe" else init_mlp
            for k, v in init_ffn(gen, cfg, device, n_blocks=nb).items():
                params[f"blocks/s{i}_ffn/{k}"] = v
    params["final_norm/scale"] = init_rmsnorm(cfg.d_model, device)["scale"]
    if cfg.n_patches:   # VLM: the projector of the (stub) vision tower
        params["patch_proj/w"] = _init(gen, (cfg.d_model, cfg.d_model),
                                       cfg.d_model ** -0.5, cfg.cdtype,
                                       device)
    return params


# --------------------------------------------------------------- forward ----
def _call(fn, *args):
    return fn(*args)


def _checkpoint(fn, *args):
    if current_plan() is not None:
        # the recompute runs every collective of the region, as the forward
        return checkpoint(fn, *args, use_reentrant=False, early_stop=False)
    return checkpoint(fn, *args, use_reentrant=False)


def _ffn(cfg: ModelConfig, bp: dict, i: int, ffn: str, x: torch.Tensor,
         ckpt=_call):
    """Sub-layer i's FFN residual step: (x, the MoE's aux loss or None).
    ``ckpt`` runs the FFN (`_checkpoint` makes it a checkpoint region)."""
    if ffn == "none":
        return x, None
    h = rmsnorm(sub(bp, f"s{i}_n2"), x, cfg.norm_eps)
    p = sub(bp, f"s{i}_ffn")
    if ffn == "moe":
        out, aux = ckpt(lambda p_, h_: moe_ffn(p_, cfg, h_), p, h)
        return x + out, aux
    return x + ckpt(lambda p_, h_: mlp(p_, cfg, h_), p, h), None


def _block_forward(cfg: ModelConfig, bp: dict, x: torch.Tensor,
                   use_ssd_kernel: bool = True, sublayer_remat: bool = False):
    """One pattern-repeat in full-sequence mode.  Returns (x, aux).  With
    ``sublayer_remat`` every mixer and FFN is its own checkpoint region."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = _checkpoint if sublayer_remat else _call
    S = x.shape[1]
    c = 1024 if S >= 2048 else S        # the reference backbone's chunks
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        h = rmsnorm(sub(bp, f"s{i}_n1"), x, cfg.norm_eps)
        if mixer == "attn":
            out = ckpt(lambda p_, h_: attn_forward(
                p_, cfg, h_, q_chunk=c, kv_chunk=c), sub(bp, f"s{i}_mix"), h)
        else:
            out = ckpt(lambda p_, h_: mamba_forward(
                p_, cfg, h_, use_ssd_kernel=use_ssd_kernel),
                sub(bp, f"s{i}_mix"), h)
        x, a = _ffn(cfg, bp, i, ffn, x + out, ckpt)
        if a is not None:
            aux = aux + a
    return x, aux


def backbone(cfg: ModelConfig, params: dict, x: torch.Tensor,
             use_ssd_kernel: bool = True):
    """Run the block stack on embeddings x: (B, S, D).  With autograd
    recording, each block is a checkpoint: the backward keeps only the
    blocks' inputs and recomputes one block at a time (one sub-layer at a
    time where the pattern has more than one)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ckpt = torch.is_grad_enabled()
    sublayer = ckpt and len(cfg.pattern) > 1
    for b in range(cfg.n_blocks):
        bp = _block(params, b)
        if ckpt:
            x, a = _checkpoint(lambda h, bp=bp: _block_forward(
                cfg, gather_block(bp), h, use_ssd_kernel, sublayer), x)
        else:
            x, a = _block_forward(cfg, gather_block(bp), x,
                                  use_ssd_kernel)
        aux = aux + a
    return x, aux


def embed_inputs(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                 extra_embeds=None) -> torch.Tensor:
    """Token embedding; a VLM prepends its patch features (B, P, D)
    through the projector (under a plan that splits its columns over
    "model", the rank's columns gathered whole)."""
    x = embed(sub(params, "embed"), cfg, tokens)
    if extra_embeds is not None:
        pe = extra_embeds.to(cfg.cdtype) @ params["patch_proj/w"]
        plan = current_plan()
        if plan is not None and plan.proj_tp:
            pe = gather_columns(plan, pe)
        x = torch.cat([pe, x], dim=1)
    return x


def lm_logits(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
              use_ssd_kernel: bool = True, extra_embeds=None):
    """Full-sequence logits (B, S, V) of the S text tokens and the aux
    loss.  A VLM's image positions are dropped from the output (the loss
    and the distillation are on text tokens).  Under a tensor-parallel
    plan the logits are the rank's vocabulary columns."""
    params = gather_top(params)
    x = embed_inputs(cfg, params, tokens, extra_embeds)
    x, aux = backbone(cfg, params, x, use_ssd_kernel)
    if extra_embeds is not None:
        x = x[:, extra_embeds.shape[1]:]
    x = rmsnorm(sub(params, "final_norm"), x, cfg.norm_eps)
    return unembed(sub(params, "embed"), cfg, x), aux


# ----------------------------------------------------------------- decode ----
def _window(cfg: ModelConfig, seq_len: int) -> int:
    """Ring-buffer slots of an attention sub-layer for ``seq_len``."""
    return min(seq_len, cfg.sliding_window or seq_len)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device) -> dict:
    """Decode cache for ``seq_len`` positions, ``s{i}/<leaf>`` with the
    leading n_blocks axis: attention sub-layers get ring buffers ``k`` and
    ``v`` of (n_blocks, batch, W, Kh, hd), W = min(seq_len, sliding_window);
    Mamba sub-layers the O(1) SSM state and conv windows.  Under a plan
    (`shardctx.current_plan`) each leaf is this rank's part under
    `sharding.cache_specs` (`TPPlan.cache_shapes`)."""
    plan = current_plan()
    full = {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        if mixer == "attn":
            kv = ((batch, _window(cfg, seq_len), cfg.eff_kv_heads, cfg.hd),
                  cfg.cdtype)
            one = {"k": kv, "v": kv}
        else:
            one = ssm_cache_shapes(cfg, batch)
        for k, (shape, dtype) in one.items():
            full[f"s{i}/{k}"] = ((cfg.n_blocks,) + shape, dtype)
    shapes = {k: sh for k, (sh, _) in full.items()}
    if plan is not None:
        shapes = plan.cache_shapes(cfg, shapes, batch)
    return {k: torch.zeros(shapes[k], dtype=dt, device=device)
            for k, (_, dt) in full.items()}


def _block_decode(cfg: ModelConfig, bp: dict, bc: dict, x: torch.Tensor,
                  pos: torch.Tensor, ring=None):
    """One pattern-repeat of decode; writes its cache views ``bc`` in
    place."""
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        h = rmsnorm(sub(bp, f"s{i}_n1"), x, cfg.norm_eps)
        mine = sub(bc, f"s{i}")
        if mixer == "attn":
            out, _ = attn_decode_step(sub(bp, f"s{i}_mix"), cfg, h, mine, pos,
                                      ring)
        else:
            out, new = mamba_decode_step(sub(bp, f"s{i}_mix"), cfg, h, mine)
            for k, v in new.items():
                mine[k].copy_(v)
        x, _ = _ffn(cfg, bp, i, ffn, x + out)
    return x


def _ring(cfg: ModelConfig, plan, cache: dict, batch: int, seq_len):
    """The `launch.tp.Ring` of the rings in ``cache``, this rank's part of
    a cache of ``seq_len`` positions for a global ``batch`` (a rank's
    slots do not tell the whole window: 6 of them are a ring of 6 kept
    whole or of 24 split 4 ways)."""
    if seq_len is None:
        raise ValueError(f"{cfg.name}: a decode step under a plan needs "
                         f"the seq_len its cache was made for")
    ring = plan.ring(cfg, batch, _window(cfg, seq_len))
    local = next(v.shape[2] for k, v in cache.items() if k.endswith("/k"))
    if ring.local_window != local:
        raise ValueError(f"{cfg.name}: the cache holds {local} slots a "
                         f"ring, not the {ring.local_window} of this rank's "
                         f"part of {seq_len} positions at batch {batch}")
    return ring


def decode_step(cfg: ModelConfig, params: dict, cache: dict,
                token: torch.Tensor, pos, seq_len: int | None = None
                ) -> tuple[torch.Tensor, dict]:
    """One decode step.  token: (B,) int; ``pos``: each row's position,
    (B,) or one scalar for every row.  Returns (logits (B, V), cache).

    The cache passed in is written in place and returned: each attention
    ring buffer (``s{i}/k``, ``s{i}/v``) at slot pos % W of each row, and
    every Mamba leaf (``state``, ``conv_*``) whole.  A caller that needs
    the cache as it was clones it first.

    Under a tensor-parallel plan ``params`` are the rank's slices,
    ``cache`` the rank's part (`init_cache`), and ``token`` and ``pos`` the
    whole batch's: the rank takes its rows where the cache splits the
    batch over "data" and returns their whole-vocabulary logits
    (B_local, V); where the pattern has attention, ``seq_len`` is the one
    `init_cache` was given.
    The leaves outside the stack are gathered over "data" once a step and
    each block's once a block (FSDP), as `lm_logits` does."""
    plan = current_plan()
    ring = None
    if plan is not None:
        if any(m == "attn" for m, _ in cfg.pattern):
            ring = _ring(cfg, plan, cache, token.shape[0], seq_len)
        if plan.batch_split(token.shape[0]):
            token = plan.data_rows({"t": token})["t"]
            if torch.as_tensor(pos).ndim:
                pos = plan.data_rows({"p": pos})["p"]
        params = gather_top(params)
    x = embed(sub(params, "embed"), cfg, token[:, None])
    pos = torch.as_tensor(pos, device=x.device)
    for b in range(cfg.n_blocks):
        x = _block_decode(cfg, gather_block(_block(params, b)),
                          {k: v[b] for k, v in cache.items()}, x, pos, ring)
    x = rmsnorm(sub(params, "final_norm"), x, cfg.norm_eps)
    return gather_vocab(unembed(sub(params, "embed"), cfg, x)[:, 0]), cache


# ---------------------------------------------------------------- prefill ----
def _block_prefill(cfg: ModelConfig, bp: dict, x: torch.Tensor,
                   seq_len: int):
    """Full-seq forward that also emits this block's decode cache."""
    cache = {}
    S = x.shape[1]
    c = min(1024, S)
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        h = rmsnorm(sub(bp, f"s{i}_n1"), x, cfg.norm_eps)
        if mixer == "attn":
            W = _window(cfg, seq_len)
            out, k, v = attn_forward(sub(bp, f"s{i}_mix"), cfg, h,
                                     q_chunk=c, kv_chunk=c, return_kv=True)
            cache[f"s{i}/k"] = ring_layout(k, W)
            cache[f"s{i}/v"] = ring_layout(v, W)
        else:
            out, mc = mamba_forward(sub(bp, f"s{i}_mix"), cfg, h,
                                    return_cache=True)
            cache.update({f"s{i}/{k}": v for k, v in mc.items()})
        x, _ = _ffn(cfg, bp, i, ffn, x + out)
    return x, cache


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
            seq_len: int | None = None, extra_embeds=None):
    """Prefill: returns (last-token logits (B, V), decode cache).
    ``seq_len`` (default: the prompt's length, a VLM's patches included)
    sizes the attention ring buffers; a VLM's patches take the first
    positions, so its decode starts at S + n_patches.  Each block's cache
    lands in the stacked (n_blocks, ...) leaves as it is made, so no
    second copy of the cache is held."""
    x = embed_inputs(cfg, params, tokens, extra_embeds)
    seq_len = seq_len or x.shape[1]
    cache = {}
    for b in range(cfg.n_blocks):
        x, c = _block_prefill(cfg, _block(params, b), x, seq_len)
        for k, v in c.items():
            if b == 0:
                cache[k] = v.new_empty((cfg.n_blocks,) + tuple(v.shape))
            cache[k][b] = v
    x = rmsnorm(sub(params, "final_norm"), x[:, -1:], cfg.norm_eps)
    return unembed(sub(params, "embed"), cfg, x)[:, 0], cache
