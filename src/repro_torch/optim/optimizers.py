"""Minimal functional optimizers over flat dicts of tensors (mirrors
``repro/optim/optimizers.py``; not `torch.optim`).

API: ``opt = sgd(lr)``; ``state = opt.init(params)``;
``params, state = opt.update(grads, params, state, step)``.  Every update
is elementwise, so the same call serves parameters stacked over clients as
(K, ...).  Adam's state is one flat dict with ``m/<name>`` and
``v/<name>`` entries.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

F32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable          # (grads, params, state, step) -> (params, state)


def _lr_at(lr, step):
    return lr(step) if callable(lr) else lr


def sgd(lr) -> Optimizer:
    def init(params):
        return {}

    def update(grads, params, state, step):
        s = _lr_at(lr, step)
        return {k: p - (s * grads[k]).to(p.dtype)
                for k, p in params.items()}, state

    return Optimizer("sgd", init, update)


def momentum(lr, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {k: torch.zeros_like(p, dtype=F32) for k, p in params.items()}

    def update(grads, params, state, step):
        s = _lr_at(lr, step)
        vel = {k: beta * v + grads[k].to(F32) for k, v in state.items()}
        return {k: p - (s * vel[k]).to(p.dtype)
                for k, p in params.items()}, vel

    return Optimizer("momentum", init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        z = {k: torch.zeros_like(p, dtype=F32) for k, p in params.items()}
        return {**{f"m/{k}": v for k, v in z.items()},
                **{f"v/{k}": v.clone() for k, v in z.items()}}

    def update(grads, params, state, step):
        s = _lr_at(lr, step)
        t = np.float32(step + 1)
        # the bias corrections in fp32, as the reference computes them
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        new_p, new_s = {}, {}
        for k, p in params.items():
            g = grads[k].to(F32)
            m = b1 * state[f"m/{k}"] + (1 - b1) * g
            v = b2 * state[f"v/{k}"] + (1 - b2) * torch.square(g)
            new_p[k] = p - (s * (m / bc1)
                            / (torch.sqrt(v / bc2) + eps)).to(p.dtype)
            new_s[f"m/{k}"], new_s[f"v/{k}"] = m, v
        return new_p, new_s

    return Optimizer("adam", init, update)


def make(name: str, lr) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adam": adam}[name](lr)
