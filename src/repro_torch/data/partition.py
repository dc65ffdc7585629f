"""Federated data partitioners (paper §4.1 "Data partitions"; mirrors
``iid``, ``shard_non_iid`` and ``gather_clients`` of
``repro/data/partition.py``).  Both partitioners return index stacks
(K, I_k) so callers can gather fixed-size client stacks."""
from __future__ import annotations

import torch


def iid(gen: torch.Generator, n: int, K: int) -> torch.Tensor:
    """Shuffle, then split into K equal shards (the remainder is dropped)."""
    per = n // K
    return torch.randperm(n, generator=gen, device=gen.device)[:per * K
                                                               ].reshape(K, per)


def shard_non_iid(gen: torch.Generator, labels: torch.Tensor, K: int,
                  shards_per_client: int = 2) -> torch.Tensor:
    """The paper's strong non-IID split: sort by label, cut into
    ``shards_per_client * K`` shards and deal ``shards_per_client`` to each
    client, which then holds about that many classes."""
    n = labels.shape[0]
    S = shards_per_client * K
    shard_size = n // S
    order = torch.argsort(labels, stable=True)
    shards = order[:S * shard_size].reshape(S, shard_size)
    assign = torch.randperm(S, generator=gen, device=gen.device).reshape(
        K, shards_per_client)
    return shards[assign].reshape(K, shards_per_client * shard_size)


def gather_clients(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor):
    """idx: (K, I) -> stacked client arrays (K, I, ...)."""
    return x[idx], y[idx]
