"""Benchmark 1: Federated Averaging (McMahan et al., AISTATS'17; paper
§2.1), mirroring ``repro/core/fedavg.py``.

One round: broadcast w0 -> E local epochs per client -> size-weighted
parameter average (Eq. 3).  BatchNorm running statistics are averaged like
any other leaf.  `FedAvgAlgorithm` runs the round."""
from __future__ import annotations

import torch

from ..lanes import lane_sum, weighted_lane_sum
from .trees import tree_map

F32 = torch.float32


def weighted_average(stacked, weights: torch.Tensor):
    """Eq. 3: sum_k (I_k / I) w_k over the leading client axis of every
    leaf, every cross-client sum a `lanes.lane_sum`."""
    w = weights.to(F32)
    w = w / lane_sum(w)
    return tree_map(lambda leaf: weighted_lane_sum(w, leaf).to(leaf.dtype),
                    stacked)
