"""Dataset assembly for federated image experiments: private/open/test
sets and the client stacks (mirrors ``FederatedImageTask`` and
``build_image_task`` of ``repro/data/pipeline.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import generator
from . import partition, synthetic


@dataclass
class FederatedImageTask:
    x_clients: torch.Tensor      # (K, I_k, H, W, 1)
    y_clients: torch.Tensor      # (K, I_k)
    open_x: torch.Tensor         # (I_o, H, W, 1)
    x_test: torch.Tensor
    y_test: torch.Tensor
    n_classes: int


def build_image_task(seed: int, K: int, n_private: int, n_open: int,
                     n_test: int, distribution: str = "non_iid",
                     hw: int = 16, n_classes: int = 10,
                     device="cuda") -> FederatedImageTask:
    """Private, open and test sets of the ``digits`` task, made on
    ``device`` from one generator seeded with ``seed``, and the private
    set dealt to K clients (``"iid"`` or the paper's ``"non_iid"``)."""
    gen = generator(device, seed)
    x, y = synthetic.make_digits(gen, n_private, n_classes, hw)
    open_x, _ = synthetic.make_digits(gen, n_open, n_classes, hw)
    x_test, y_test = synthetic.make_digits(gen, n_test, n_classes, hw)
    if distribution == "iid":
        idx = partition.iid(gen, n_private, K)
    elif distribution == "non_iid":
        idx = partition.shard_non_iid(gen, y, K, 2)
    elif distribution.startswith("dirichlet"):
        raise NotImplementedError(
            "the dirichlet partition is not ported yet: ROADMAP Queue 1, data")
    else:
        raise ValueError(distribution)
    xc, yc = partition.gather_clients(x, y, idx)
    return FederatedImageTask(xc, yc, open_x, x_test, y_test, n_classes)
