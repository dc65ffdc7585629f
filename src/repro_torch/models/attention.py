"""Grouped-query attention with RoPE, optional QKV bias, sliding windows,
flash-style chunked softmax, a ring-buffer KV cache for decode and the
encoder-decoder's cross-attention (mirrors ``repro/models/attention.py``).

Shapes: q (B, Sq, H, hd) / k, v (B, Skv, Kh, hd); GQA groups G = H // Kh.
All softmax statistics accumulate in fp32.  Plain PyTorch, one path on the
CPU and the card, as the reference's attention is plain ``jnp``.

Decode differs from the reference in two ways the serving engine needs:
each row of the batch carries its own position (the reference takes one
scalar and is vmapped over slots), and the new key and value are written
into the ring buffer in place (the reference donates the cache).
"""
from __future__ import annotations

import torch

from .shardctx import copy_to_model, current_plan, reduce_model, ring_merge
from .base import ModelConfig
from .layers import F32, _init, apply_rope, rope_freqs

NEG_INF = -1e30


# ------------------------------------------------------------------ init ----
def init_attn(gen: torch.Generator, cfg: ModelConfig, device,
              n_blocks: int | None = None) -> dict:
    """One attention mixer's parameters; with ``n_blocks`` every leaf gets
    that leading axis (the stacked block layout)."""
    d, h, kh, hd = cfg.d_model, cfg.eff_heads, cfg.eff_kv_heads, cfg.hd
    if cfg.pad_heads and cfg.n_kv_heads != cfg.n_heads:
        raise ValueError(f"{cfg.name}: pad_heads requires MHA")
    lead = () if n_blocks is None else (n_blocks,)
    s = d ** -0.5

    def normal(shape, scale):
        return _init(gen, lead + shape, scale, cfg.cdtype, device)

    p = {"wq": normal((d, h * hd), s),
         "wk": normal((d, kh * hd), s),
         "wv": normal((d, kh * hd), s),
         "wo": normal((h * hd, d), (h * hd) ** -0.5)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * hd), ("bk", kh * hd), ("bv", kh * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=cfg.cdtype,
                                  device=device)
    return p


def qkv_proj(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """q (B, S, H, hd), k and v (B, S, Kh, hd): the heads the projections
    hold (a rank's under tensor parallelism)."""
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, -1, cfg.hd), k.reshape(B, S, -1, cfg.hd),
            v.reshape(B, S, -1, cfg.hd))


def head_mask(cfg: ModelConfig, o: torch.Tensor,
              first: int = 0) -> torch.Tensor:
    """Zero the padded heads so pad_heads preserves numerics exactly
    (padded wo rows then contribute nothing and receive no gradient).
    ``o``'s heads are the global heads ``first``, ``first + 1``, ..."""
    if not cfg.pad_heads or cfg.pad_heads == cfg.n_heads:
        return o
    mask = (torch.arange(first, first + o.shape[-2], device=o.device)
            < cfg.n_heads).to(o.dtype)
    return o * mask[..., :, None]


def _fit_chunk(S: int, c: int) -> int:
    """Largest divisor of S that is <= c."""
    c = min(c, S)
    while S % c:
        c -= 1
    return c


# -------------------------------------------------- flash-style attention ----
def _chunk_attn(q, k, v, q_pos, kv_pos, scale, causal, window):
    """One (q-chunk, kv-chunk) tile.  q: (B,Kh,G,Cq,hd) k/v: (B,Ckv,Kh,hd).
    Returns unnormalized (m, l, acc) contributions in fp32."""
    s = torch.einsum("bkgqd,bckd->bkgqc", q, k).to(F32) * scale
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device)
    if causal:
        mask &= q_pos[:, None] >= kv_pos[None, :]
    if window is not None:
        mask &= kv_pos[None, :] > q_pos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                                        # (B,Kh,G,Cq)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqc,bckd->bkgqd", p.to(v.dtype), v).to(F32)
    return m, l, acc


def flash_attention(q, k, v, *, causal=True, window=None,
                    q_chunk=1024, kv_chunk=1024, q_offset=0):
    """Chunked online-softmax attention.  q: (B,Sq,H,hd), k/v: (B,Skv,Kh,hd).
    Query chunk i sits at positions ``q_offset + i * q_chunk + ...``; it
    visits only the static range of kv chunks its causal and window masks
    can reach, and merges them with fp32 running (max, sum, accumulator)."""
    B, Sq, H, hd = q.shape
    Skv, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    scale = hd ** -0.5
    q_chunk = _fit_chunk(Sq, q_chunk)
    kv_chunk = _fit_chunk(Skv, kv_chunk)
    nq, nkv = Sq // q_chunk, Skv // kv_chunk
    dev = q.device

    qg = q.reshape(B, Sq, Kh, G, hd)
    outs = []
    for i in range(nq):
        qi = qg[:, i * q_chunk:(i + 1) * q_chunk].permute(0, 2, 3, 1, 4)
        q_pos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        # static causal/window range of kv chunks for this q chunk
        hi, lo = nkv, 0
        if causal:
            hi = min(nkv, (q_offset + (i + 1) * q_chunk + kv_chunk - 1)
                     // kv_chunk)
        if window is not None:
            lo = max(0, (q_offset + i * q_chunk - window + 1) // kv_chunk)
        m = torch.full((B, Kh, G, q_chunk), NEG_INF, dtype=F32, device=dev)
        l = torch.zeros((B, Kh, G, q_chunk), dtype=F32, device=dev)
        acc = torch.zeros((B, Kh, G, q_chunk, hd), dtype=F32, device=dev)
        for c in range(lo, lo + max(hi - lo, 1)):
            sl = slice(c * kv_chunk, (c + 1) * kv_chunk)
            kv_pos = c * kv_chunk + torch.arange(kv_chunk, device=dev)
            mc, lc, accc = _chunk_attn(qi, k[:, sl], v[:, sl], q_pos, kv_pos,
                                       scale, causal, window)
            m_new = torch.maximum(m, mc)
            a1, a2 = torch.exp(m - m_new), torch.exp(mc - m_new)
            l = l * a1 + lc * a2
            acc = acc * a1[..., None] + accc * a2[..., None]
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]        # (B,Kh,G,Cq,hd)
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, hd))
    return torch.cat(outs, dim=1).to(q.dtype)


# ------------------------------------------------------------- self-attn ----
def attn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor, *,
                 positions=None, causal=True, q_chunk=1024,
                 kv_chunk=1024, return_kv: bool = False):
    """Training / prefill self-attention over the full sequence.  With
    ``return_kv`` also returns the (RoPE'd) keys and the values.  Under a
    tensor-parallel plan that splits the heads the rank runs its heads (GQA
    groups whole) and ``wo``'s partial sums are all-reduced over
    "model"; otherwise attention is replicated there."""
    B, S, _ = x.shape
    plan = current_plan()
    split = plan is not None and plan.attn_tp
    if split:
        x = copy_to_model(plan, x)
    q, k, v = qkv_proj(p, cfg, x)
    if cfg.pos_embed == "rope":
        if positions is None:
            positions = torch.arange(S, device=x.device)
        cos, sin = rope_freqs(cfg, positions)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = head_mask(cfg, flash_attention(q, k, v, causal=causal,
                                       window=cfg.sliding_window,
                                       q_chunk=q_chunk, kv_chunk=kv_chunk),
                  plan.head_start(q.shape[2]) if split else 0)
    out = o.reshape(B, S, -1) @ p["wo"]
    if split:
        out = reduce_model(plan, out)
    return (out, k, v) if return_kv else out


# ----------------------------------------------------------- decode cache ----
def init_kv_cache(cfg: ModelConfig, batch: int, window: int, device) -> dict:
    shape = (batch, window, cfg.eff_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.cdtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=device)}


def ring_layout(kv: torch.Tensor, W: int) -> torch.Tensor:
    """The decode ring of W slots after a prefill of kv: (B, S, Kh, hd):
    slot t % W holds token t of the last W; zero-padded when S < W."""
    S = kv.shape[1]
    last = kv[:, -W:]
    if S >= W:
        return torch.roll(last, S % W, dims=1)
    pad = torch.zeros((kv.shape[0], W - S) + tuple(kv.shape[2:]),
                      dtype=kv.dtype, device=kv.device)
    return torch.cat([last, pad], dim=1)


def attn_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     cache: dict, pos, ring=None) -> tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, D); cache k/v: (B, W, Kh, hd) ring
    buffers holding (RoPE'd) keys for positions (pos-W, pos-1], token t at
    slot t % W.  ``pos`` is each row's current position, (B,) or a scalar
    for every row.  Writes row b's new key and value at slot pos[b] % W of
    ``cache`` in place and returns (out (B, 1, D), cache).

    Under a tensor-parallel plan that splits the heads the rank runs its
    heads against its key/value heads, ``wo`` row-parallel and all-reduced
    over "model", as `attn_forward`.  ``ring`` (`launch.tp.Ring`) says how
    `sharding.cache_specs` cut the ring: where it splits the window over
    ranks, ``cache`` holds this rank's slots [first, first + W_local) of
    the ring of ``ring.window`` slots, a row's new key and value are
    written only by the rank holding its slot, and each rank's (max, sum,
    weighted values) over its slots merge over the ring's ranks
    (`shardctx.ring_merge`)."""
    B = x.shape[0]
    plan = current_plan()
    split = plan is not None and plan.attn_tp
    if split:
        x = copy_to_model(plan, x)
    ck, cv = cache["k"], cache["v"]
    Wl = ck.shape[1]
    spread = ring is not None and ring.shards > 1
    W, lo = (ring.window, ring.first_slot) if spread else (Wl, 0)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64).expand(B)
    q, k, v = qkv_proj(p, cfg, x)
    if cfg.pos_embed == "rope":
        cos, sin = rope_freqs(cfg, pos[:, None])              # (B, 1, hd/2)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)

    rows = torch.arange(B, device=x.device)
    if spread:
        # only the rank holding a row's slot writes it (no data-dependent
        # shapes: every rank writes back its old value elsewhere)
        slot = pos % W
        own = ((slot >= lo) & (slot < lo + Wl))[:, None, None]
        idx = torch.clamp(slot - lo, 0, Wl - 1)
        ck[rows, idx] = torch.where(own, k[:, 0], ck[rows, idx])
        cv[rows, idx] = torch.where(own, v[:, 0], cv[rows, idx])
    else:
        ck[rows, pos % W] = k[:, 0]
        cv[rows, pos % W] = v[:, 0]

    # position held by each slot j: largest t <= pos with t = j (mod W)
    j = lo + torch.arange(Wl, device=x.device)
    p_ = pos[:, None]
    slot_pos = p_ - torch.remainder(p_ - j, W)                # (B, Wl)
    valid = (slot_pos >= 0) & (slot_pos > p_ - W)
    if cfg.sliding_window is not None:
        valid &= slot_pos > p_ - cfg.sliding_window

    Kh, hd = ck.shape[2], cfg.hd
    G = q.shape[2] // Kh
    qg = q.reshape(B, Kh, G, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qg, ck).to(F32) * hd ** -0.5
    mask = valid[:, None, None, :]
    s = torch.where(mask, s, NEG_INF)
    if spread:
        m = s.amax(dim=-1, keepdim=True)
        e = torch.where(mask, torch.exp(s - m), 0.0)
        acc = torch.einsum("bkgc,bckd->bkgd", e.to(cv.dtype), cv).to(F32)
        o = ring_merge(plan, ring, m, e.sum(dim=-1), acc).to(cv.dtype)
    else:
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgc,bckd->bkgd", w.to(cv.dtype), cv)
    o = head_mask(cfg, o.reshape(B, 1, Kh * G, hd),
                  plan.head_start(Kh * G) if split else 0).reshape(
        B, 1, Kh * G * hd) @ p["wo"]
    if split:
        o = reduce_model(plan, o)
    return o, cache


# ----------------------------------------------------------- cross-attn -----
def cross_attn_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                       enc_k: torch.Tensor,
                       enc_v: torch.Tensor) -> torch.Tensor:
    """Decoder cross-attention (whisper).  enc_k/v precomputed: (B, Se, Kh,
    hd).  No RoPE on cross-attention.  Under a tensor-parallel plan that
    splits the heads the rank runs its heads against its key/value heads
    (`cross_kv` of its ``wk``/``wv``), ``wo`` row-parallel and all-reduced
    over "model", as `attn_forward`."""
    B, S, _ = x.shape
    plan = current_plan()
    split = plan is not None and plan.attn_tp
    if split:
        x = copy_to_model(plan, x)
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, -1, cfg.hd)
    o = head_mask(cfg, flash_attention(q, enc_k, enc_v, causal=False),
                  plan.head_start(q.shape[2]) if split else 0)
    out = o.reshape(B, S, -1) @ p["wo"]
    return reduce_model(plan, out) if split else out


def cross_kv(p: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """The cross-attention's keys and values of the encoder states
    enc_out: (B, Se, D), each (B, Se, Kh, hd): the key/value heads ``wk``
    and ``wv`` hold (a rank's under tensor parallelism)."""
    B, Se, _ = enc_out.shape
    k, v = enc_out @ p["wk"], enc_out @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(B, Se, -1, cfg.hd), v.reshape(B, Se, -1, cfg.hd))
