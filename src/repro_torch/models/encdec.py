"""Whisper-style encoder-decoder transformer (mirrors
``repro/models/encdec.py``).

The mel-spectrogram and conv feature extractor is a stub, as in the
reference: ``frames`` are precomputed frame embeddings (B, F, D).  The
encoder's non-causal self-attention stack, the decoder's causal
self-attention, cross-attention and learned positions, and the KV-cached
decode are real.

Parameters are flat, with the reference's names: ``embed/tok``,
``pos_dec`` (max_seq, D), ``enc/{n1,n2}/scale``, ``enc/attn/<leaf>``,
``enc/mlp/<leaf>`` with a leading ``enc_layers`` axis, ``dec/{n1,n2,n3}/
scale``, ``dec/self/<leaf>``, ``dec/cross/<leaf>``, ``dec/mlp/<leaf>``
with a leading ``n_layers`` axis, ``enc_norm/scale`` and
``final_norm/scale``.  The decode cache holds ``self/k``, ``self/v`` (the
decoder's ring buffers, (n_layers, B, W, Kh, hd)) and ``cross_k``,
``cross_v`` (each layer's keys and values of the encoder states, (n_layers,
B, Se, Kh, hd)).

Where autograd records, each encoder and decoder block is a checkpoint
(the reference's ``remat``).  As everywhere in the port, the decode step
takes each row's position and writes the self-attention rings in place.
`decoder_prefill` fills the rings with the prompt's keys and values, so
prefill then decode equals the teacher-forced decoder; the reference's
audio prefill leaves them empty (ROADMAP, deviation 16).

Under a tensor-parallel plan (`shardctx.active_plan`, `launch.tp`) the
encoder's and the decoder's blocks run their parts of it as the decoder
stack's do (`attention`, `layers.mlp`): attention, the cross-attention
and the MLP on the rank's heads and columns, each block's leaves gathered
over "data" inside its checkpoint (`shardctx.gather_block` of ``enc`` or
``dec``), the leaves outside the stacks once a pass (`gather_top`); each
data rank encodes its own rows of ``frames``.  The encoder states enter
the decoder through one `copy_to_model`: every decoder layer's ``wk`` and
``wv`` read them, each rank its own heads' columns, so their gradient is
summed over "model" once, before the encoder's backward.  The decode
cache is the rank's part under `sharding.cache_specs`; where it splits
the encoder positions over "data" (a batch "data" does not divide) each
rank attends over its positions and the ranks' partial softmaxes merge
(`shardctx.ring_merge`), as a self-attention ring split over ranks does.
"""
from __future__ import annotations

import torch

from .attention import (attn_decode_step, attn_forward,
                        cross_attn_forward, cross_kv, head_mask, init_attn,
                        ring_layout)
from .base import ModelConfig
from .layers import (F32, _init, embed, init_embed, init_mlp, init_rmsnorm,
                     mlp, rmsnorm, sub, unembed)
from .shardctx import (copy_to_model, current_plan, gather_block, gather_top,
                       gather_vocab, reduce_model, ring_merge)
from .transformer import _block, _call, _checkpoint, _ring, _window


def _sinusoid(F: int, D: int, device="cpu") -> torch.Tensor:
    """(F, D) f32: the sines of F positions at D/2 frequencies, then their
    cosines."""
    pos = torch.arange(F, dtype=F32, device=device)[:, None]
    dim = torch.arange(0, D, 2, dtype=F32, device=device)[None, :]
    ang = pos / (10_000.0 ** (dim / D))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ------------------------------------------------------------------- init ----
def init_encdec(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    """Flat parameters drawn from ``gen`` (see the module's docstring for
    the names)."""
    params = {f"embed/{k}": v for k, v in init_embed(gen, cfg, device).items()}
    params["pos_dec"] = _init(gen, (cfg.max_seq, cfg.d_model), 0.01,
                              cfg.cdtype, device)

    def stack(name, n, parts):
        for part, init in parts:
            if init is None:
                params[f"{name}/{part}/scale"] = torch.ones(
                    (n, cfg.d_model), dtype=F32, device=device)
                continue
            for k, v in init(gen, cfg, device, n_blocks=n).items():
                params[f"{name}/{part}/{k}"] = v

    stack("enc", cfg.enc_layers, (("n1", None), ("attn", init_attn),
                                  ("n2", None), ("mlp", init_mlp)))
    stack("dec", cfg.n_layers, (("n1", None), ("self", init_attn),
                                ("n2", None), ("cross", init_attn),
                                ("n3", None), ("mlp", init_mlp)))
    params["enc_norm/scale"] = init_rmsnorm(cfg.d_model, device)["scale"]
    params["final_norm/scale"] = init_rmsnorm(cfg.d_model, device)["scale"]
    return params


# --------------------------------------------------------------- forward ----
def _enc_block(cfg: ModelConfig, bp: dict, h: torch.Tensor) -> torch.Tensor:
    h = h + attn_forward(sub(bp, "attn"), cfg,
                         rmsnorm(sub(bp, "n1"), h, cfg.norm_eps),
                         causal=False)
    return h + mlp(sub(bp, "mlp"), cfg, rmsnorm(sub(bp, "n2"), h,
                                                cfg.norm_eps))


def encode(cfg: ModelConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, F, D) conv-stub output.  Returns the encoder states.
    Under a plan ``params`` are the rank's slices, those outside the
    stacks gathered (`gather_top`), and ``frames`` its rows."""
    x = frames.to(cfg.cdtype) + _sinusoid(frames.shape[1], cfg.d_model,
                                          frames.device).to(cfg.cdtype)
    ckpt = _checkpoint if torch.is_grad_enabled() else _call
    for i in range(cfg.enc_layers):
        x = ckpt(lambda h, bp=_block(params, i, "enc"): _enc_block(
            cfg, gather_block(bp, "enc"), h), x)
    return rmsnorm(sub(params, "enc_norm"), x, cfg.norm_eps)


def _dec_block(cfg: ModelConfig, bp: dict, h: torch.Tensor,
               enc_out: torch.Tensor, return_kv: bool = False):
    """One decoder block; with ``return_kv`` also its self-attention's keys
    and values and its cross-attention's."""
    out, k, v = attn_forward(sub(bp, "self"), cfg,
                             rmsnorm(sub(bp, "n1"), h, cfg.norm_eps),
                             return_kv=True)
    h = h + out
    ek, ev = cross_kv(sub(bp, "cross"), cfg, enc_out)
    h = h + cross_attn_forward(sub(bp, "cross"), cfg,
                               rmsnorm(sub(bp, "n2"), h, cfg.norm_eps),
                               ek, ev)
    h = h + mlp(sub(bp, "mlp"), cfg, rmsnorm(sub(bp, "n3"), h, cfg.norm_eps))
    return (h, k, v, ek, ev) if return_kv else h


def decoder_logits(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
    """Teacher-forced decoder.  tokens: (B, S) -> logits (B, S, V) (under
    a plan, as `encode`: the rank's vocabulary columns)."""
    plan = current_plan()
    if plan is not None and plan.attn_tp:
        # every layer's cross-attention reads the states through the
        # rank's wk/wv columns: their gradient is summed once, here
        enc_out = copy_to_model(plan, enc_out)
    S = tokens.shape[1]
    x = embed(sub(params, "embed"), cfg, tokens) + params["pos_dec"][:S]
    ckpt = _checkpoint if torch.is_grad_enabled() else _call
    for i in range(cfg.n_layers):
        x = ckpt(lambda h, e, bp=_block(params, i, "dec"): _dec_block(
            cfg, gather_block(bp, "dec"), h, e), x, enc_out)
    x = rmsnorm(sub(params, "final_norm"), x, cfg.norm_eps)
    return unembed(sub(params, "embed"), cfg, x)


def encdec_lm_logits(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                     frames: torch.Tensor):
    """Full-sequence logits (B, S, V) and a zero aux loss (under a plan:
    the rank's vocabulary columns; the leaves outside the stacks gathered
    over "data" once)."""
    params = gather_top(params)
    enc_out = encode(cfg, params, frames)
    logits = decoder_logits(cfg, params, tokens, enc_out)
    return logits, torch.zeros((), dtype=F32, device=logits.device)


# ------------------------------------------------------------------ decode ---
def init_encdec_cache(cfg: ModelConfig, params: dict, batch: int,
                      seq_len: int, enc_out: torch.Tensor) -> dict:
    """Empty self-attention rings of min(seq_len, sliding_window) slots and
    each decoder layer's cross keys and values of ``enc_out``.  Under a
    plan, this rank's part under `sharding.cache_specs`: ``enc_out`` the
    encoder states of its rows (`encdec_init_cache`), the rings' and the
    cross keys' and values' heads its own where the plan splits them, and
    where the cache splits the encoder positions, its positions."""
    plan = current_plan()
    kv = (cfg.n_layers, batch, _window(cfg, seq_len), cfg.eff_kv_heads,
          cfg.hd)
    shapes = {"self/k": kv, "self/v": kv}
    if plan is not None:
        shapes = plan.cache_shapes(cfg, shapes, batch)
    cache = {k: torch.zeros(sh, dtype=cfg.cdtype, device=enc_out.device)
             for k, sh in shapes.items()}
    cross = [cross_kv(gather_block(sub(_block(params, i, "dec"), "cross"),
                                  "dec/cross"), cfg, enc_out)
             for i in range(cfg.n_layers)]
    for name, part in (("cross_k", 0), ("cross_v", 1)):
        cache[name] = torch.stack([kv[part] for kv in cross])
        if plan is not None:
            ring = plan.ring(cfg, batch, cache[name].shape[2])
            if ring.shards > 1:
                cache[name] = cache[name].narrow(
                    2, ring.first_slot, ring.local_window).contiguous()
    return cache


def encdec_init_cache(cfg: ModelConfig, params: dict, batch: int,
                      seq_len: int, frames: torch.Tensor) -> dict:
    """`init_encdec_cache` of the encoder states of ``frames`` (B, F, D),
    without gradients; under a plan the rank encodes its rows of them
    where the cache splits the batch over "data", else all of them."""
    plan = current_plan()
    with torch.no_grad():
        if plan is not None and plan.batch_split(batch):
            frames = plan.data_rows({"f": frames})["f"]
        enc_out = encode(cfg, gather_top(params), frames)
        return init_encdec_cache(cfg, params, batch, seq_len, enc_out)


def decoder_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                    enc_out: torch.Tensor, seq_len: int | None = None):
    """The teacher-forced decoder over the prompt that also builds the
    decode cache: returns (last-token logits (B, V), cache).  Each layer's
    ring holds the prompt's keys and values (slot t % W for token t), as
    the dense `transformer.prefill` does; ``seq_len`` (default: the
    prompt's length) sizes the rings."""
    S = tokens.shape[1]
    W = _window(cfg, seq_len or S)
    x = embed(sub(params, "embed"), cfg, tokens) + params["pos_dec"][:S]
    ks, vs, eks, evs = [], [], [], []
    for i in range(cfg.n_layers):
        x, k, v, ek, ev = _dec_block(cfg, _block(params, i, "dec"), x,
                                     enc_out, return_kv=True)
        ks.append(ring_layout(k, W))
        vs.append(ring_layout(v, W))
        eks.append(ek)
        evs.append(ev)
    x = rmsnorm(sub(params, "final_norm"), x[:, -1:], cfg.norm_eps)
    cache = {"self/k": torch.stack(ks), "self/v": torch.stack(vs),
             "cross_k": torch.stack(eks), "cross_v": torch.stack(evs)}
    return unembed(sub(params, "embed"), cfg, x)[:, 0], cache


def _cross_decode(cfg: ModelConfig, p: dict, hh: torch.Tensor,
                  ck: torch.Tensor, cv: torch.Tensor,
                  cross=None) -> torch.Tensor:
    """One token's cross-attention, hh: (B, 1, D), ck/cv: (B, Se, Kh, hd),
    as the reference's einsums.  Under a plan that splits the heads the
    rank runs its heads against its key/value heads, ``wo`` row-parallel
    and all-reduced over "model"; ``cross`` (`launch.tp.Ring` of the
    encoder positions) says where the cache splits the positions over
    ranks: each rank's (max, sum, weighted values) over its positions
    merge over them (`shardctx.ring_merge`)."""
    B = hh.shape[0]
    plan = current_plan()
    split = plan is not None and plan.attn_tp
    if split:
        hh = copy_to_model(plan, hh)
    q = hh @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, -1, cfg.hd)
    s = torch.einsum("bhd,bshd->bhs", q, ck).to(F32) * cfg.hd ** -0.5
    if cross is not None and cross.shards > 1:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        acc = torch.einsum("bhs,bshd->bhd", e.to(cv.dtype), cv).to(F32)
        o = ring_merge(plan, cross, m, e.sum(dim=-1), acc).to(cv.dtype)
    else:
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bhs,bshd->bhd", w.to(cv.dtype), cv)
    heads = o.shape[1]
    o = head_mask(cfg, o[:, None], plan.head_start(heads) if split else 0)
    out = o.reshape(B, 1, heads * cfg.hd) @ p["wo"]
    return reduce_model(plan, out) if split else out


def _cross_ring(cfg: ModelConfig, plan, cache: dict, batch: int):
    """The `launch.tp.Ring` of the cross cache's ``n_audio_frames``
    encoder positions for a global ``batch``; raises unless ``cache``
    holds this rank's part of them."""
    ring = plan.ring(cfg, batch, cfg.n_audio_frames)
    local = cache["cross_k"].shape[2]
    if ring.local_window != local:
        raise ValueError(f"{cfg.name}: the cross cache holds {local} "
                         f"encoder positions, not the {ring.local_window} "
                         f"of this rank's part of {cfg.n_audio_frames} at "
                         f"batch {batch}")
    return ring


def encdec_decode_step(cfg: ModelConfig, params: dict, cache: dict,
                       token: torch.Tensor, pos,
                       seq_len: int | None = None):
    """One decoder token at each row's position ``pos`` ((B,) or a scalar).
    Writes the self-attention rings of ``cache`` in place and returns
    (logits (B, V), cache).  Under a plan, as `transformer.decode_step`:
    ``params`` the rank's slices, ``cache`` its part
    (`encdec_init_cache`), ``token`` and ``pos`` the whole batch's,
    ``seq_len`` the one the cache was made for; returns its rows'
    whole-vocabulary logits."""
    plan = current_plan()
    ring = cross = None
    if plan is not None:
        ring = _ring(cfg, plan, cache, token.shape[0], seq_len)
        cross = _cross_ring(cfg, plan, cache, token.shape[0])
        if plan.batch_split(token.shape[0]):
            token = plan.data_rows({"t": token})["t"]
            if torch.as_tensor(pos).ndim:
                pos = plan.data_rows({"p": pos})["p"]
        params = gather_top(params)
    B = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device).to(torch.int64).expand(B)
    x = embed(sub(params, "embed"), cfg, token[:, None]) \
        + params["pos_dec"][pos][:, None]
    for i in range(cfg.n_layers):
        bp = gather_block(_block(params, i, "dec"), "dec")
        rings = {"k": cache["self/k"][i], "v": cache["self/v"][i]}
        out, _ = attn_decode_step(sub(bp, "self"), cfg,
                                  rmsnorm(sub(bp, "n1"), x, cfg.norm_eps),
                                  rings, pos, ring)
        x = x + out
        x = x + _cross_decode(cfg, sub(bp, "cross"),
                              rmsnorm(sub(bp, "n2"), x, cfg.norm_eps),
                              cache["cross_k"][i], cache["cross_v"][i],
                              cross)
        x = x + mlp(sub(bp, "mlp"), cfg, rmsnorm(sub(bp, "n3"), x,
                                                 cfg.norm_eps))
    x = rmsnorm(sub(params, "final_norm"), x, cfg.norm_eps)
    return gather_vocab(unembed(sub(params, "embed"), cfg, x)[:, 0]), cache
