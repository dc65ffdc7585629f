"""Mixture-of-Experts FFN with GShard-style grouped capacity dispatch
(mirrors ``repro/models/moe.py``).

Tokens are viewed as (groups, group_size); each group dispatches at most
``capacity`` tokens to each expert through one-hot einsums (no scatter),
the reference's formulation step by step, so the same tokens are routed,
ranked and dropped.  A (token, choice) past its expert's capacity is
dropped: the token's residual passes it by.

The reference computes the MoE outside any Pallas kernel; here it is plain
PyTorch (``einsum``) as well.

Under a tensor-parallel plan that splits the experts over "model"
(`launch.tp.TPPlan.ep`: expert parallelism) every rank routes every token
with the replicated router, so the same choices are ranked and dropped as
in one process and every rank computes the same load-balance loss; the
tokens and the top-k gates then pass `copy_to_model` (the router reads
the tokens before it, so its gradient is whole on every rank and not
summed again), the rank runs its E/M experts' slices of the dispatch and
combine, and its partial output is all-reduced (`reduce_model`).  Under
"data" a rank's share of the tokens must hold whole routing groups, or
capacity would drop other choices than one process.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .base import ModelConfig
from .layers import _init
from .shardctx import copy_to_model, current_plan, reduce_model

F32 = torch.float32


def init_moe(gen: torch.Generator, cfg: ModelConfig, device,
             n_blocks: int | None = None) -> dict:
    """The router (D, E) in f32 and the experts' ``w_gate``/``w_up`` (E, D,
    F) and ``w_down`` (E, F, D) in ``cfg.cdtype``; with ``n_blocks`` every
    leaf gets that leading axis.  The experts are drawn one (block, expert)
    matrix at a time, so the f32 draw never holds more than one of them
    (a whole stacked leaf of llama4-scout at 12 layers is 32 GB in f32)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = () if n_blocks is None else (n_blocks,)
    s_in, s_out = d ** -0.5, f ** -0.5

    def experts(shape, scale):
        out = torch.empty(lead + (e,) + shape, dtype=cfg.cdtype,
                          device=device)
        for m in out.view((-1,) + shape):
            m.copy_(_init(gen, shape, scale, cfg.cdtype, device))
        return out

    return {"router": _init(gen, lead + (d, e), s_in, F32, device),
            "w_gate": experts((d, f), s_in),
            "w_up": experts((d, f), s_in),
            "w_down": experts((f, d), s_out)}


def capacity(cfg: ModelConfig, group_size: int) -> int:
    c = math.ceil(group_size * cfg.top_k * cfg.capacity_factor
                  / cfg.n_experts)
    return max(c, 1)


def route(p: dict, cfg: ModelConfig, xg: torch.Tensor):
    """The router of a (G, gs, D) token grouping: ``(gate, expert, rank,
    keep, aux)``, each (G, gs, K) but the scalar load-balance loss.
    ``gate`` are the top-k gates renormalised, ``expert`` their experts
    (ties to the lowest index, as ``lax.top_k``), ``rank`` each (token,
    choice)'s place in its expert's buffer (an exclusive count over the
    group's (gs * K) choices, token-major), ``keep`` where it is below the
    capacity."""
    G, gs, _ = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    gates = torch.softmax(xg.to(F32) @ p["router"], dim=-1)   # (G, gs, E)

    # load-balance auxiliary loss (Switch/GShard style)
    me = gates.mean(dim=1)                                    # (G, E)
    ce = F.one_hot(gates.argmax(dim=-1), E).to(F32).mean(dim=1)
    aux = (me * ce).sum(dim=-1).mean() * E

    # a stable descending sort keeps tied gates in index order
    top_g, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_g, top_i = top_g[..., :K], top_i[..., :K]             # (G, gs, K)
    top_g = top_g / torch.clamp(top_g.sum(dim=-1, keepdim=True), min=1e-9)

    ohf = F.one_hot(top_i, E).reshape(G, gs * K, E)
    rank = ((torch.cumsum(ohf, dim=1) - ohf) * ohf).sum(dim=-1)
    rank = rank.reshape(G, gs, K)
    return top_g, top_i, rank, rank < capacity(cfg, gs), aux


def dispatch(top_g, top_i, rank, keep, E: int, C: int, dtype):
    """The (G, gs, E, C) dispatch and combine tensors of `route`'s output
    in ``dtype``: one-hots of (expert, rank) where a choice is kept, the
    combine weighted by its gate.  A dropped choice's rank is clamped into
    range and its one-hot zeroed by ``keep``."""
    disp = (F.one_hot(top_i, E).to(dtype)[..., :, None]
            * F.one_hot(rank.clamp(max=C - 1), C).to(dtype)[..., None, :]
            * keep[..., None, None].to(dtype))                # (G, gs, K, E, C)
    comb = (disp * top_g[..., None, None].to(dtype)).sum(dim=2)
    return disp.sum(dim=2), comb


def moe_ffn(p: dict, cfg: ModelConfig,
            x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Token-choice top-k with per-group
    capacity; overflow tokens are dropped (pass through the residual)."""
    B, S, D = x.shape
    N = B * S
    plan = current_plan()
    if plan is not None and plan.data.size > 1 and N % cfg.moe_group_size:
        raise ValueError(
            f"{cfg.name}: a data rank's {N} tokens do not hold whole MoE "
            f"routing groups of {cfg.moe_group_size}: capacity would drop "
            f"other choices than one process")
    gs = min(cfg.moe_group_size, N)
    if N % gs:
        raise ValueError(f"{cfg.name}: {N} tokens do not split into MoE "
                         f"groups of {gs}")
    xg = x.reshape(N // gs, gs, D)
    top_g, top_i, rank, keep, aux = route(p, cfg, xg)
    split = plan is not None and plan.ep
    if split:
        top_g, xg = copy_to_model(plan, top_g), copy_to_model(plan, xg)
    disp, comb = dispatch(top_g, top_i, rank, keep, cfg.n_experts,
                          capacity(cfg, gs), x.dtype)
    if split:       # this rank's experts (the leaves hold their slices)
        n = p["w_up"].shape[0]
        e0 = plan.expert_start(n)
        disp, comb = disp.narrow(2, e0, n), comb.narrow(2, e0, n)

    xin = torch.einsum("gsec,gsd->egcd", disp, xg)            # (E, G, C, D)
    if cfg.act == "swiglu":
        h = (F.silu(torch.einsum("egcd,edf->egcf", xin, p["w_gate"]))
             * torch.einsum("egcd,edf->egcf", xin, p["w_up"]))
    else:
        h = F.gelu(torch.einsum("egcd,edf->egcf", xin, p["w_up"]),
                   approximate="tanh")
    eout = torch.einsum("egcf,efd->egcd", h, p["w_down"])     # (E, G, C, D)
    out = torch.einsum("gsec,egcd->gsd", comb, eout)
    if split:
        out = reduce_model(plan, out)
    return out.reshape(B, S, D), aux
