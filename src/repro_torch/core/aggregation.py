"""Logit aggregation operators (paper Section 3).

Clients upload per-sample probability vectors over the open batch; the
server aggregates them into the global logit:

  * SA  (Eq. 16): simple average.
  * ERA (Eq. 13): softmax(average / T) with T << 1 (paper: T = 0.1).
  * weighted ERA: reliability-weighted average.
  * top-k sparsified exchange for large vocabularies; ERA is applied after
    densifying the mean.

``use_kernel=True`` routes the (K, N, C) classification stacks through the
fused CUDA kernels K1/K2 (`repro_torch.kernels.ops`), exactly where the
reference routes them to its Pallas kernels.
"""
from __future__ import annotations

import torch

from ..lanes import lane_sum, weighted_lane_sum

F32 = torch.float32


def sa(local_probs: torch.Tensor) -> torch.Tensor:
    """local_probs: (K, ..., C) -> (..., C).  Simple aggregation (Eq. 16)."""
    return local_probs.to(F32).mean(dim=0)


def era(local_probs: torch.Tensor, temperature: float = 0.1,
        use_kernel: bool = False) -> torch.Tensor:
    """Entropy-reduction aggregation (Eq. 13): sharpen the mean."""
    if use_kernel:
        from ..kernels import ops as kops
        return kops.era_sharpen(local_probs, temperature)
    return torch.softmax(sa(local_probs) / temperature, dim=-1)


def _normalize_weights(weights: torch.Tensor) -> torch.Tensor:
    """(K,) nonneg -> normalized; an all-zero vector falls back to uniform."""
    w = weights.to(F32)
    total = lane_sum(w)
    uniform = torch.full_like(w, 1.0 / w.shape[0])
    return torch.where(total > 0, w / torch.clamp(total, min=1e-9), uniform)


def _kernel_eligible(local_probs: torch.Tensor) -> bool:
    """The fused weighted kernel takes the (K, N, C) classification shape;
    higher-rank stacks keep the einsum path."""
    return local_probs.ndim == 3


def weighted_sa(local_probs: torch.Tensor, weights: torch.Tensor,
                use_kernel: bool = False) -> torch.Tensor:
    """Weighted simple aggregation.  Absent clients (weight 0) contribute
    exactly nothing."""
    w = _normalize_weights(weights)
    if use_kernel and _kernel_eligible(local_probs):
        from ..kernels import ops as kops
        return kops.weighted_mean(local_probs, w)
    return weighted_lane_sum(w, local_probs)


def weighted_era(local_probs: torch.Tensor, weights: torch.Tensor,
                 temperature: float = 0.1,
                 use_kernel: bool = False) -> torch.Tensor:
    """Reliability-weighted ERA. weights: (K,) nonneg, normalized here; an
    all-zero vector falls back to uniform weights (== plain ERA)."""
    if use_kernel and _kernel_eligible(local_probs):
        from ..kernels import ops as kops
        return kops.weighted_era_sharpen(local_probs,
                                         _normalize_weights(weights),
                                         temperature)
    return torch.softmax(weighted_sa(local_probs, weights) / temperature,
                         dim=-1)


def participation_weights(mask: torch.Tensor, staleness=None,
                          decay: float = 1.0, base=None) -> torch.Tensor:
    """Per-client aggregation weights for a partial-participation round:
    mask x base x decay**staleness.  Absent clients get exactly zero; if
    every participant modulates to zero, the raw mask is used instead."""
    w = mask.to(F32)
    if base is not None:
        w = w * base.to(F32)
    if staleness is not None:
        w = w * torch.pow(torch.tensor(decay, dtype=F32, device=w.device),
                          staleness.to(F32))
    return torch.where(w.sum() > 0, w, mask.to(F32))


def aggregate(local_probs: torch.Tensor, method: str = "era",
              temperature: float = 0.1, weights=None,
              use_kernel: bool = False) -> torch.Tensor:
    """Dispatch on the paper's aggregation methods.  With ``weights`` and
    ``use_kernel=True`` the weighted kernel (K2) serves every method."""
    if method == "sa":
        if weights is not None:
            return weighted_sa(local_probs, weights, use_kernel)
        return sa(local_probs)
    if method == "era":
        if weights is not None:
            return weighted_era(local_probs, weights, temperature, use_kernel)
        return era(local_probs, temperature, use_kernel)
    if method == "weighted_era":
        if weights is None:
            raise ValueError("aggregation 'weighted_era' needs weights")
        return weighted_era(local_probs, weights, temperature, use_kernel)
    raise ValueError(method)


# -------------------------- top-k sparsified exchange (beyond paper) ---------
def topk_compress(probs: torch.Tensor, k: int):
    """probs: (..., C) -> (values (..., k), indices (..., k)), renormalized."""
    v, i = torch.topk(probs, k, dim=-1)
    v = v / torch.clamp(v.sum(dim=-1, keepdim=True), min=1e-9)
    return v.to(F32), i


def topk_decompress(values: torch.Tensor, indices: torch.Tensor,
                    C: int) -> torch.Tensor:
    """Densify a sparsified distribution back to (..., C)."""
    out = torch.zeros(values.shape[:-1] + (C,), dtype=F32,
                      device=values.device)
    return out.scatter(-1, indices.long(), values.to(F32))


def era_topk(local_values: torch.Tensor, local_indices: torch.Tensor, C: int,
             temperature: float = 0.1, k_out=None):
    """Aggregate sparsified client uploads (K, ..., k): segment-sum mean ->
    sharpen, optionally re-sparsified for the broadcast leg.

    The K*k (index, value) pairs of each row are summed into one (n, C)
    accumulator one slot column at a time, in client order.  A column holds
    one pair per row, so no call writes one address twice: the sum is the
    same on every run (``index_put_(accumulate=True)`` would use atomics
    on the card)."""
    K = local_values.shape[0]
    kk = local_values.shape[-1]
    inner = tuple(local_values.shape[1:-1])
    n = 1
    for d in inner:
        n *= d
    val = torch.movedim(local_values.to(F32), 0, -2).reshape(n, K * kk)
    idx = torch.movedim(local_indices.long(), 0, -2).reshape(n, K * kk)
    acc = torch.zeros((n, C), dtype=F32, device=local_values.device)
    for j in range(K * kk):
        acc.scatter_add_(1, idx[:, j:j + 1], val[:, j:j + 1])
    mean = (acc / K).reshape(inner + (C,))
    g = torch.softmax(mean / temperature, dim=-1)
    if k_out is not None:
        return topk_compress(g, k_out)
    return g
