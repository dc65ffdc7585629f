"""Mamba2 (SSD — state-space duality, arXiv:2405.21060) mixer (mirrors
``repro/models/ssm.py``).

Chunked SSD forward: within-chunk quadratic blocks plus the inter-chunk
linear recurrence over chunk states, a Python loop where the reference has
``lax.scan``.  The within-chunk block takes one of two routes, the
reference's ``use_ssd_kernel`` switch: K5 (`kernels.ops.ssd_chunk`: the
CUDA kernel on a card tensor, its plain version on a CPU one), which has no
backward and serves inference, or `_chunk_local`, the model's own
differentiable block, which training runs through.  Decode is the
O(1) recurrent step carrying (ssm_state, conv_state).

The x/B/C projections and their causal convs are separate parameter leaves
(w_x / w_b / w_c), as in the reference.

Under a tensor-parallel plan that splits the heads over "model"
(`launch.tp.TPPlan.ssm_tp`) the mixer runs the rank's heads: its input
passes `copy_to_model`; ``w_z``/``w_x``/``w_dt``, ``dt_bias``/``a_log``/
``d_skip``, the x conv and ``norm_scale`` are the rank's heads or
channels; ``w_b``/``w_c`` and their conv leaves give the rank's columns of
G*N, which `gather_model_sum` makes whole before the rank takes the
groups its heads read (whole groups, or one group a few ranks share);
SSD (K5 or `_chunk_local`) runs on the rank's heads; the gated norm's sum
of squares over the whole d_inner is all-reduced (`all_reduce_both`), and
``w_out`` is row-parallel (`reduce_model`).  The
decode step does the same against the rank's part of the cache (the
state's heads, the conv windows' channels and columns).  Without such a
plan the mixer runs whole (replicated on "model").
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops as kops
from .base import ModelConfig
from .layers import _init
from .shardctx import (all_reduce_both, copy_to_model, current_plan,
                       gather_model_sum, reduce_model)

F32 = torch.float32


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device,
               n_blocks: int | None = None) -> dict:
    """One Mamba2 mixer's parameters; with ``n_blocks`` every leaf gets that
    leading axis (the stacked block layout) and is drawn in one call."""
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    gn = cfg.ssm_groups * cfg.ssm_state
    w = cfg.ssm_conv
    lead = () if n_blocks is None else (n_blocks,)
    s = d ** -0.5
    cd = cfg.cdtype

    def normal(shape, scale, dtype=cd):
        return _init(gen, lead + shape, scale, dtype, device)

    def full(shape, value, dtype):
        return torch.full(lead + shape, value, dtype=dtype, device=device)

    u = torch.rand(lead + (h,), generator=gen, device=device, dtype=F32)
    dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "w_z": normal((d, di), s),
        "w_x": normal((d, di), s),
        "w_b": normal((d, gn), s),
        "w_c": normal((d, gn), s),
        "cw_x": normal((w, di), di ** -0.5),
        "cw_b": normal((w, gn), gn ** -0.5),
        "cw_c": normal((w, gn), gn ** -0.5),
        "cb_x": full((di,), 0.0, cd),
        "cb_b": full((gn,), 0.0, cd),
        "cb_c": full((gn,), 0.0, cd),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),          # inv softplus
        "w_dt": normal((d, h), s),
        "a_log": full((h,), 0.0, F32),                          # A = -exp(.)
        "d_skip": full((h,), 1.0, F32),
        "norm_scale": full((di,), 1.0, F32),
        "w_out": normal((di, d), di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv via shifted slices. x: (B,S,C), w: (wlen,C)."""
    wlen, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, wlen - 1, 0))
    out = sum(pad[:, i:i + S] * w[i] for i in range(wlen))
    return F.silu(out + b)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., Q) -> (..., Q, Q) with T[i, j] = sum_{j<k<=i} dA_k (i >= j),
    -inf above the diagonal."""
    cum = torch.cumsum(dA, dim=-1)
    T = cum[..., :, None] - cum[..., None, :]
    Q = dA.shape[-1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return T.masked_fill(~mask, float("-inf"))


def _chunk_local(xr, dtr, dAr, Br, Cr, hpg: int) -> torch.Tensor:
    """Within-chunk quadratic block, differentiable (the reference's
    ``_chunk_local``; K5 computes the same function without a backward).
    xr: (B,nc,Q,H,P), dtr/dAr: (B,nc,Q,H), Br/Cr: (B,nc,Q,G,N).  The
    scores C.B are computed once a group and shared by its heads (the
    reference repeats B and C over the heads first; the sums are the
    same)."""
    Bsz, nc, Q, H, P = xr.shape
    G = Br.shape[3]
    L = torch.exp(_segsum(dAr.permute(0, 1, 3, 2)))           # (B,nc,H,Q,Q)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cr, Br)       # (B,nc,G,Q,Q)
    M = (scores[:, :, :, None] * L.reshape(Bsz, nc, G, hpg, Q, Q)
         * dtr.permute(0, 1, 3, 2).reshape(Bsz, nc, G, hpg, 1, Q))
    return torch.einsum("bcgjqk,bckgjp->bcqgjp", M,
                        xr.reshape(Bsz, nc, Q, G, hpg, P)).reshape(
        Bsz, nc, Q, H, P)


def ssd_chunked(x, dt, a_log, Bm, Cm, chunk: int,
                return_state: bool = False, use_kernel: bool = True):
    """SSD over a full sequence.

    x: (B,S,H,P); dt: (B,S,H) post-softplus; a_log: (H,); Bm/Cm: (B,S,G,N).
    Returns y (B,S,H,P) fp32 (and the final state (B,H,P,N) if requested).
    The within-chunk blocks go through K5 (`kernels.ops.ssd_chunk`), or
    through `_chunk_local` with ``use_kernel=False`` (training).  The
    chunk-end states and the off-diagonal term contract each group's B or C
    with its heads without repeating B and C over the heads (the reference
    repeats them first; the products and sums are the same)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:
        # pad the tail: dt=0 => decay exp(0)=1 and zero input contribution,
        # so real positions and the final state are unaffected (causal)
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // Q
    hpg = H // G

    A = -torch.exp(a_log)
    dA = dt.to(F32) * A                                        # (B,S,H)
    xr = x.to(F32).reshape(Bsz, nc, Q, H, P)
    dAr = dA.reshape(Bsz, nc, Q, H)
    dtr = dt.to(F32).reshape(Bsz, nc, Q, H)
    Br = Bm.to(F32).reshape(Bsz, nc, Q, G, N)
    Cr = Cm.to(F32).reshape(Bsz, nc, Q, G, N)

    cum = torch.cumsum(dAr, dim=2)

    # 1. diagonal (within-chunk) blocks
    local = kops.ssd_chunk if use_kernel else _chunk_local
    y_diag = local(xr, dtr, dAr, Br, Cr, hpg)

    # 2. per-chunk end states
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    xw = (xr * (dtr * decay_to_end)[..., None]).reshape(Bsz, nc, Q, G, hpg, P)
    states = torch.einsum("bcqgn,bcqgjp->bcgjpn", Br, xw).reshape(
        Bsz, nc, H, P, N)                                      # (B,nc,H,P,N)

    # 3. inter-chunk recurrence: prev[c] is the state entering chunk c
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (B,nc,H)
    prev = torch.empty_like(states)
    carry = torch.zeros((Bsz, H, P, N), dtype=F32, device=x.device)
    for c in range(nc):
        prev[:, c] = carry
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]

    # 4. off-diagonal contribution
    y_off = torch.einsum("bcqgn,bcgjpn->bcqgjp", Cr,
                         prev.reshape(Bsz, nc, G, hpg, P, N))
    y_off = y_off.reshape(Bsz, nc, Q, H, P) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(Bsz, S, H, P)[:, :S_orig]
    if return_state:
        return y, carry
    return y


def _project(p, cfg, x):
    """x: (B,S,D) -> (z, xs_pre, b_pre, c_pre, dt) pre-conv projections."""
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    b = x @ p["w_b"]
    c = x @ p["w_c"]
    dt = F.softplus((x @ p["w_dt"]).to(F32) + p["dt_bias"])
    return z, xs, b, c, dt


def _mixer_plan():
    """The plan in force where it splits the mixer's heads, else None."""
    plan = current_plan()
    return plan if plan is not None and plan.ssm_tp else None


def _rank_groups(plan, cfg: ModelConfig, heads: int) -> slice:
    """The groups (along G) this rank's ``heads`` heads read: a run of
    whole groups, or the one group they lie in (`launch.tp.check_family`
    refuses heads that straddle groups)."""
    hpg = cfg.ssm_heads // cfg.ssm_groups
    g0 = plan.model.rank * heads // hpg
    return slice(g0, g0 + max(heads // hpg, 1))


def _groups(plan, cfg: ModelConfig, t: torch.Tensor,
            heads: int) -> torch.Tensor:
    """B or C after its conv, (..., G*N) or the rank's columns of it
    under ``plan``, as (..., groups, N): all G groups, or under ``plan``
    the groups the rank's ``heads`` heads read."""
    if plan is None:
        return t.reshape(t.shape[:-1] + (cfg.ssm_groups, cfg.ssm_state))
    t = gather_model_sum(plan, t)
    t = t.reshape(t.shape[:-1] + (cfg.ssm_groups, cfg.ssm_state))
    return t[..., _rank_groups(plan, cfg, heads), :]


def _gate_norm_out(p, cfg, y, z, plan=None):
    """The gated RMSNorm over the whole d_inner and ``w_out``; under
    ``plan`` ``y`` and ``z`` are the rank's channels, the sum of squares
    all-reduced and the product's partial sums too."""
    y = y * F.silu(z.to(F32))
    if plan is None:
        var = torch.mean(y * y, dim=-1, keepdim=True)
    else:
        var = all_reduce_both(plan, torch.sum(y * y, dim=-1, keepdim=True)
                              ) / cfg.d_inner
    y = y * torch.rsqrt(var + cfg.norm_eps) * p["norm_scale"]
    out = y.to(cfg.cdtype) @ p["w_out"]
    return out if plan is None else reduce_model(plan, out)


def mamba_forward(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  return_cache: bool = False, use_ssd_kernel: bool = True):
    """Full-sequence Mamba2 block. x: (B, S, D).  ``use_ssd_kernel=False``
    takes the differentiable within-chunk route (`_chunk_local`).  Under
    a plan that splits the heads, ``p`` holds the rank's slices."""
    B, S, _ = x.shape
    plan = _mixer_plan()
    if plan is not None:
        x = copy_to_model(plan, x)
    H, P = p["w_dt"].shape[-1], cfg.ssm_head_dim       # the rank's heads
    z, xs_pre, b_pre, c_pre, dt = _project(p, cfg, x)
    xs = _causal_conv(xs_pre, p["cw_x"], p["cb_x"]).reshape(B, S, H, P)
    Bm = _groups(plan, cfg, _causal_conv(b_pre, p["cw_b"], p["cb_b"]), H)
    Cm = _groups(plan, cfg, _causal_conv(c_pre, p["cw_c"], p["cb_c"]), H)
    res = ssd_chunked(xs, dt, p["a_log"], Bm, Cm, cfg.ssm_chunk,
                      return_state=return_cache, use_kernel=use_ssd_kernel)
    y, final = res if return_cache else (res, None)
    y = y + p["d_skip"][:, None] * xs.to(F32)
    out = _gate_norm_out(p, cfg, y.reshape(B, S, H * P), z, plan)
    if return_cache:
        w1 = cfg.ssm_conv - 1
        cache = {"state": final,
                 "conv_x": _last(xs_pre, w1).to(cfg.cdtype),
                 "conv_b": _last(b_pre, w1).to(cfg.cdtype),
                 "conv_c": _last(c_pre, w1).to(cfg.cdtype)}
        return out, cache
    return out


def _last(a: torch.Tensor, w1: int) -> torch.Tensor:
    """The decode conv window after a prefill: the last ``w1`` pre-conv rows
    of ``a`` (B, S, C), left-padded with zeros when S < w1, which is what
    the causal conv read there.  (The reference slices ``a[:, -w1:]`` and
    keeps a window of only S rows in that case.)"""
    tail = a[:, -w1:]
    return F.pad(tail, (0, 0, w1 - tail.shape[1], 0))


def ssm_cache_shapes(cfg: ModelConfig, batch: int) -> dict:
    """{leaf: (shape, dtype)} of one Mamba sub-layer's decode cache."""
    w1 = cfg.ssm_conv - 1
    gn = cfg.ssm_groups * cfg.ssm_state
    return {
        "state": ((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                  F32),
        "conv_x": ((batch, w1, cfg.d_inner), cfg.cdtype),
        "conv_b": ((batch, w1, gn), cfg.cdtype),
        "conv_c": ((batch, w1, gn), cfg.cdtype),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in ssm_cache_shapes(cfg, batch).items()}


def _conv_step(window_prev, new, w, b):
    """window_prev: (B, wlen-1, C); new: (B, C) -> (out (B, C), new window)."""
    window = torch.cat([window_prev, new[:, None]], dim=1)
    out = F.silu(torch.einsum("bwc,wc->bc", window.to(F32), w.to(F32))
                 + b.to(F32))
    return out, window[:, 1:]


def mamba_decode_step(p: dict, cfg: ModelConfig, x: torch.Tensor,
                      cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token recurrent step. x: (B, 1, D).  Under a plan that splits
    the heads, ``p`` and ``cache`` are the rank's."""
    B = x.shape[0]
    plan = _mixer_plan()
    H, P = p["w_dt"].shape[-1], cfg.ssm_head_dim       # the rank's heads
    x1 = x[:, 0]
    z = x1 @ p["w_z"]
    dt = F.softplus((x1 @ p["w_dt"]).to(F32) + p["dt_bias"])  # (B,H)
    xs, ncx = _conv_step(cache["conv_x"], x1 @ p["w_x"], p["cw_x"], p["cb_x"])
    Bm, ncb = _conv_step(cache["conv_b"], x1 @ p["w_b"], p["cw_b"], p["cb_b"])
    Cm, ncc = _conv_step(cache["conv_c"], x1 @ p["w_c"], p["cw_c"], p["cb_c"])
    xs = xs.reshape(B, H, P)
    Bm, Cm = _groups(plan, cfg, Bm, H), _groups(plan, cfg, Cm, H)
    A = -torch.exp(p["a_log"])
    dA = torch.exp(dt * A)
    Bh = torch.repeat_interleave(Bm, H // Bm.shape[1], dim=1)
    Ch = torch.repeat_interleave(Cm, H // Cm.shape[1], dim=1)
    st = cache["state"] * dA[..., None, None] \
        + (dt[..., None] * xs)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", st, Ch) + p["d_skip"][:, None] * xs
    out = _gate_norm_out(p, cfg, y.reshape(B, H * P), z, plan)[:, None]
    return out, {"state": st, "conv_x": ncx.to(cfg.cdtype),
                 "conv_b": ncb.to(cfg.cdtype),
                 "conv_c": ncc.to(cfg.cdtype)}
