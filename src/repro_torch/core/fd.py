"""Benchmark 2: Federated Distillation (Jeong et al. 2018; paper §2.2),
mirroring ``repro/core/fd.py``.

Clients exchange *per-class average* probability vectors instead of
per-sample logits:

  Eq. 4: t_{k,n} = mean of F(d|w_k) over client k's samples with label n
  Eq. 5: t_{g,n} = mean over clients that own class n
  Eq. 6: per-sample distill target debiases the client's own contribution
  Eq. 7: update with CE(labels) + gamma * CE(distill target)

The functions take one client; `FDAlgorithm` lifts them over the client
axis with ``vmap``."""
from __future__ import annotations

import torch

from ..lanes import lane_sum
from .client import predict_probs

F32 = torch.float32


def per_label_logits(apply_fn, params, state, x, y, n_classes: int):
    """Eq. 4 for one client -> (t (C, C), present (C,))."""
    probs = predict_probs(apply_fn, params, state, x)                  # (I, C)
    oh = (y[:, None] == torch.arange(n_classes, device=y.device)).to(F32)
    counts = oh.sum(dim=0)                                             # (C,)
    sums = oh.T @ probs                                                # (C, C)
    t = sums / torch.clamp(counts[:, None], min=1.0)
    return t, counts > 0


def aggregate_fd(tk: torch.Tensor, present: torch.Tensor):
    """Eq. 5: class-wise mean over owning clients.
    tk: (K, C, C), present: (K, C) -> (t_g (C, C), n_owners (C,)).  Both
    cross-client sums are `lanes.lane_sum`s (the reference's are einsum
    contractions)."""
    m = present.to(F32)                                                # (K, C)
    n_own = lane_sum(m)
    tg = lane_sum(m[:, :, None] * tk.to(F32)) \
        / torch.clamp(n_own[:, None], min=1.0)
    return tg, n_own


def distill_targets(tg, tk_self, n_own, y):
    """Eq. 6 per sample: remove the client's own logit from the average.
    tg: (C, C); tk_self: (C, C); n_own: (C,); y: (I,) -> (I, C)."""
    K_nl = torch.clamp(n_own, min=2.0)                 # guard |K| - 1 >= 1
    debias = (K_nl[:, None] * tg - tk_self) / (K_nl[:, None] - 1.0)
    # clients that are sole owner of a class fall back to the global average
    debias = torch.where((n_own > 1)[:, None], debias, tg)
    return debias[y]
