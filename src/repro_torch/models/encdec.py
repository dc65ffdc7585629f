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
"""
from __future__ import annotations

import torch

from .attention import (attn_decode_step, attn_forward, cross_attn_forward,
                        cross_kv, head_mask, init_attn, init_kv_cache,
                        ring_layout)
from .base import ModelConfig
from .layers import (F32, _init, embed, init_embed, init_mlp, init_rmsnorm,
                     mlp, rmsnorm, sub, unembed)
from .transformer import _block, _call, _checkpoint, _window


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
    """frames: (B, F, D) conv-stub output.  Returns the encoder states."""
    x = frames.to(cfg.cdtype) + _sinusoid(frames.shape[1], cfg.d_model,
                                          frames.device).to(cfg.cdtype)
    ckpt = _checkpoint if torch.is_grad_enabled() else _call
    for i in range(cfg.enc_layers):
        x = ckpt(lambda h, bp=_block(params, i, "enc"): _enc_block(
            cfg, bp, h), x)
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
    """Teacher-forced decoder.  tokens: (B, S) -> logits (B, S, V)."""
    S = tokens.shape[1]
    x = embed(sub(params, "embed"), cfg, tokens) + params["pos_dec"][:S]
    ckpt = _checkpoint if torch.is_grad_enabled() else _call
    for i in range(cfg.n_layers):
        x = ckpt(lambda h, e, bp=_block(params, i, "dec"): _dec_block(
            cfg, bp, h, e), x, enc_out)
    x = rmsnorm(sub(params, "final_norm"), x, cfg.norm_eps)
    return unembed(sub(params, "embed"), cfg, x)


def encdec_lm_logits(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                     frames: torch.Tensor):
    """Full-sequence logits (B, S, V) and a zero aux loss."""
    enc_out = encode(cfg, params, frames)
    logits = decoder_logits(cfg, params, tokens, enc_out)
    return logits, torch.zeros((), dtype=F32, device=logits.device)


# ------------------------------------------------------------------ decode ---
def init_encdec_cache(cfg: ModelConfig, params: dict, batch: int,
                      seq_len: int, enc_out: torch.Tensor) -> dict:
    """Empty self-attention rings of min(seq_len, sliding_window) slots and
    each decoder layer's cross keys and values of ``enc_out``."""
    kv = init_kv_cache(cfg, batch, _window(cfg, seq_len), enc_out.device)
    cache = {f"self/{k}": v[None].expand((cfg.n_layers,) + tuple(v.shape))
             .contiguous() for k, v in kv.items()}
    cross = [cross_kv(sub(_block(params, i, "dec"), "cross"), cfg, enc_out)
             for i in range(cfg.n_layers)]
    cache["cross_k"] = torch.stack([k for k, _ in cross])
    cache["cross_v"] = torch.stack([v for _, v in cross])
    return cache


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
                  ck: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention, hh: (B, 1, D), ck/cv: (B, Se, Kh, hd),
    as the reference's einsums."""
    B = hh.shape[0]
    q = hh @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, cfg.eff_heads, cfg.hd)
    s = torch.einsum("bhd,bshd->bhs", q, ck).to(F32) * cfg.hd ** -0.5
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", w.to(cv.dtype), cv)
    o = head_mask(cfg, o[:, None])[:, 0]
    return o.reshape(B, 1, cfg.eff_heads * cfg.hd) @ p["wo"]


def encdec_decode_step(cfg: ModelConfig, params: dict, cache: dict,
                       token: torch.Tensor, pos):
    """One decoder token at each row's position ``pos`` ((B,) or a scalar).
    Writes the self-attention rings of ``cache`` in place and returns
    (logits (B, V), cache)."""
    B = token.shape[0]
    pos = torch.as_tensor(pos, device=token.device).to(torch.int64).expand(B)
    x = embed(sub(params, "embed"), cfg, token[:, None]) \
        + params["pos_dec"][pos][:, None]
    for i in range(cfg.n_layers):
        bp = _block(params, i, "dec")
        ring = {"k": cache["self/k"][i], "v": cache["self/v"][i]}
        out, _ = attn_decode_step(sub(bp, "self"), cfg,
                                  rmsnorm(sub(bp, "n1"), x, cfg.norm_eps),
                                  ring, pos)
        x = x + out
        x = x + _cross_decode(cfg, sub(bp, "cross"),
                              rmsnorm(sub(bp, "n2"), x, cfg.norm_eps),
                              cache["cross_k"][i], cache["cross_v"][i])
        x = x + mlp(sub(bp, "mlp"), cfg, rmsnorm(sub(bp, "n3"), x,
                                                 cfg.norm_eps))
    x = rmsnorm(sub(params, "final_norm"), x, cfg.norm_eps)
    return unembed(sub(params, "embed"), cfg, x)[:, 0], cache
