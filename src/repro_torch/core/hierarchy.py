"""Two-level (edge -> server) ERA aggregation (mirrors
``repro/core/hierarchy.py``).

Edge aggregators each reduce a contiguous shard of the (K, n, C)
probability stack to one weighted partial sum; the server adds the
``n_edges`` partials in edge order and sharpens.

Parity contract (``tests/test_torch_hierarchy.py``):

* Weights are normalized globally first (`aggregation._normalize_weights`),
  so every edge scales its lanes by the coefficients the flat sum uses.
  ``n_edges=1`` computes the flat lane-order sum (or the flat kernel call) on
  the same operands and is bitwise `aggregation.weighted_sa` /
  `weighted_era`.
* ``n_edges >= 2`` re-associates the cross-client sum: within ~1e-6 of the
  flat result, not bitwise.  A zero-weight lane still contributes exactly
  nothing inside whichever shard it falls, at any depth.

``use_kernel=True`` computes each edge's partial with K2's weighted mean
(`kernels.ops.weighted_mean`, ``sharpen=False``) on the row-offset view
``probs[start:end]``; the server stage (add the partials, sharpen) is
plain torch, as the reference's is plain jnp.
"""
from __future__ import annotations

import torch

from ..lanes import weighted_lane_sum
from .aggregation import _kernel_eligible, _normalize_weights

F32 = torch.float32


def edge_shards(K: int, n_edges: int) -> list[tuple[int, int]]:
    """Contiguous ``[start, end)`` client shards, one per edge aggregator.
    Sizes differ by at most one; every client belongs to exactly one edge."""
    if not 1 <= n_edges <= K:
        raise ValueError(f"n_edges {n_edges} not in [1, {K}]")
    base, extra = divmod(K, n_edges)
    bounds, start = [], 0
    for e in range(n_edges):
        end = start + base + (1 if e < extra else 0)
        bounds.append((start, end))
        start = end
    return bounds


def _partial(probs, w, use_kernel: bool):
    if use_kernel and _kernel_eligible(probs):
        from ..kernels import ops as kops
        return kops.weighted_mean(probs, w)
    return weighted_lane_sum(w, probs)


def hierarchical_weighted_sa(local_probs: torch.Tensor, weights: torch.Tensor,
                             n_edges: int = 1,
                             use_kernel: bool = False) -> torch.Tensor:
    """Edge-sharded weighted mean: globally normalized weights, per-edge
    partial sums, the server adds the partials left to right."""
    w = _normalize_weights(weights)
    probs = local_probs.to(F32)
    if n_edges == 1:
        return _partial(probs, w, use_kernel)
    partials = [_partial(probs[start:end], w[start:end], use_kernel)
                for start, end in edge_shards(probs.shape[0], n_edges)]
    total = partials[0]
    for p in partials[1:]:
        total = total + p
    return total


def hierarchical_weighted_era(local_probs: torch.Tensor, weights: torch.Tensor,
                              temperature: float = 0.1, n_edges: int = 1,
                              use_kernel: bool = False) -> torch.Tensor:
    """Two-level ERA (Eq. 13 over an edge tree): edges reduce their shards,
    the server adds the partials and sharpens (a softmax of a partial sum
    is not a partial softmax, so the sharpen cannot sit on an edge)."""
    mean = hierarchical_weighted_sa(local_probs, weights, n_edges, use_kernel)
    return torch.softmax(mean / temperature, dim=-1)
