"""DS-FL hyperparameters and the test-set evaluation (mirrors
``repro/core/protocol.py``; its deprecated ``DSFLEngine`` is not ported:
`repro_torch.core.engine.FedEngine` runs the round)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .losses import accuracy


@dataclass(frozen=True)
class DSFLConfig:
    rounds: int = 30
    local_epochs: int = 5
    distill_epochs: int = 5
    batch_size: int = 100
    open_batch: int = 1000          # |o_r|
    lr: float = 0.1
    lr_distill: float = 0.1
    optimizer: str = "sgd"
    aggregation: str = "era"        # sa | era | weighted_era
    temperature: float = 0.1        # ERA softmax temperature
    staleness_decay: float = 0.5    # async: weight factor per round of lag
    seed: int = 0


def make_eval_fn(apply_fn, x_test, y_test, batch: int = 1000):
    """``eval_fn(params, model_state) -> {"test_acc": float}`` on the whole
    test set (``batch`` is kept for the reference's signature)."""
    def eval_fn(w, s):
        with torch.no_grad():
            logits, _ = apply_fn(w, s, x_test, False)
            return {"test_acc": float(accuracy(logits, y_test))}

    return eval_fn
