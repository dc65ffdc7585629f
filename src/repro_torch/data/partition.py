"""Federated data partitioners (paper §4.1 "Data partitions"; mirrors
``repro/data/partition.py``).  Every partitioner returns an index stack
(K, I_k) so callers can gather fixed-size client stacks.

* ``iid``            - shuffle, split into K equal shards.
* ``shard_non_iid``  - the paper's strong non-IID split.
* ``dirichlet``      - Dirichlet(alpha) label skew.
* ``ratio_non_iid``  - the 9:1 / 1:9 split of a binary task (the paper's
                       IMDb partition).

``dirichlet`` and ``ratio_non_iid`` are numpy at heart, as in the
reference: each is a numpy core seeded with one integer (``*_np``, the
reference's arithmetic line for line, so the same integer gives the same
indices) and a wrapper that draws that integer from a ``torch.Generator``.
"""
from __future__ import annotations

import numpy as np
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


def _seed_from(gen: torch.Generator) -> int:
    """The integer a numpy core is seeded with, in [0, 2**31 - 1)."""
    return int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                             device=gen.device))


def dirichlet_np(seed: int, labels: np.ndarray, K: int, alpha: float,
                 n_classes: int) -> np.ndarray:
    """Label-skew partition: each class is dealt to the K clients in
    Dirichlet(alpha) proportions; returns equal-size index stacks, each
    client's list shuffled and cut to the smallest client's size."""
    labels_np = np.asarray(labels)
    rng = np.random.default_rng(seed)
    idx_by_class = [np.where(labels_np == c)[0] for c in range(n_classes)]
    for a in idx_by_class:
        rng.shuffle(a)
    client_lists = [[] for _ in range(K)]
    for c in range(n_classes):
        props = rng.dirichlet(np.full(K, alpha))
        cuts = (np.cumsum(props) * len(idx_by_class[c])).astype(int)[:-1]
        for k, part in enumerate(np.split(idx_by_class[c], cuts)):
            client_lists[k].extend(part.tolist())
    size = min(len(l) for l in client_lists)
    return np.stack([rng.permutation(np.array(l))[:size]
                     for l in client_lists])


def ratio_non_iid_np(seed: int, labels: np.ndarray, K: int,
                     major_ratio: float = 0.9) -> np.ndarray:
    """Binary-task partition: even clients hold ``major_ratio`` positives,
    odd ones ``major_ratio`` negatives, ``len(labels) // K`` samples each
    (so each label must hold half of the samples)."""
    labels_np = np.asarray(labels)
    rng = np.random.default_rng(seed)
    pos = rng.permutation(np.where(labels_np == 1)[0])
    neg = rng.permutation(np.where(labels_np == 0)[0])
    per = len(labels_np) // K
    n_major = int(per * major_ratio)
    n_minor = per - n_major
    out, pi, ni = [], 0, 0
    for k in range(K):
        if k % 2 == 0:
            sel = np.concatenate([pos[pi:pi + n_major], neg[ni:ni + n_minor]])
            pi += n_major
            ni += n_minor
        else:
            sel = np.concatenate([neg[ni:ni + n_major], pos[pi:pi + n_minor]])
            ni += n_major
            pi += n_minor
        out.append(rng.permutation(sel))
    return np.stack(out)


def dirichlet(gen: torch.Generator, labels: torch.Tensor, K: int,
              alpha: float, n_classes: int) -> torch.Tensor:
    """`dirichlet_np` seeded from ``gen``, on ``labels``' device."""
    return torch.as_tensor(dirichlet_np(_seed_from(gen), labels.cpu().numpy(),
                                        K, alpha, n_classes),
                           dtype=torch.long, device=labels.device)


def ratio_non_iid(gen: torch.Generator, labels: torch.Tensor, K: int,
                  major_ratio: float = 0.9) -> torch.Tensor:
    """`ratio_non_iid_np` seeded from ``gen``, on ``labels``' device."""
    return torch.as_tensor(ratio_non_iid_np(_seed_from(gen),
                                            labels.cpu().numpy(), K,
                                            major_ratio),
                           dtype=torch.long, device=labels.device)


def gather_clients(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor):
    """idx: (K, I) -> stacked client arrays (K, I, ...)."""
    return x[idx], y[idx]
