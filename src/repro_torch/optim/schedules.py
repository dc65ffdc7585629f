"""Learning-rate schedules as step -> lr callables (mirrors
``repro/optim/schedules.py``), for the optimizers' ``lr``.  Each returns
the float32 value of the reference's float32 arithmetic, as a Python
float."""
from __future__ import annotations

import numpy as np

F32 = np.float32


def constant(lr: float):
    return lambda step: float(F32(lr))


def linear_warmup(lr: float, warmup: int):
    def f(step):
        return float(F32(lr) * np.minimum(F32(1.0), F32((step + 1) / warmup)))
    return f


def cosine(lr: float, total: int, warmup: int = 0, floor: float = 0.0):
    def f(step):
        w = (np.minimum(F32(1.0), F32((step + 1) / max(warmup, 1)))
             if warmup else F32(1.0))
        t = np.clip(F32((step - warmup) / max(total - warmup, 1)), F32(0.0),
                    F32(1.0))
        return float(w * (F32(floor) + F32(0.5 * (lr - floor))
                          * (F32(1.0) + np.cos(F32(np.pi) * t))))
    return f
