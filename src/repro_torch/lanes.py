"""Sums over the leading (client) axis, lane after lane.

The rounds' cross-client sums (`core.aggregation`, `core.algorithms`,
`core.fd`, `core.fedavg`, `core.hierarchy`) and K2's plain version
(`kernels.era_sharpen`) all go through `lane_sum`, whose order does not
depend on where the exact-zero lanes sit: a cohort slab of S lanes reduces
its participants bitwise as the dense K-lane stack does
(tests/test_torch_cohort.py).  It sits below both ``core`` and
``kernels`` so that neither imports the other for it.

`lane_sum` is the last row of a cumulative sum over a (K, columns) view.
The CPU accumulates it sequentially in double; the card runs one thread a
column down the client axis in fp32.  Both are torch's, not documented
contracts: tests/test_torch_cohort.py pins the CPU's and
tests/test_torch_cuda.py the card's to a sequential loop, bitwise."""
from __future__ import annotations

import torch

F32 = torch.float32


def lane_sum(v: torch.Tensor) -> torch.Tensor:
    """fp32 sum over the leading axis, lane after lane in lane order.  An
    exact-zero lane changes no bit wherever it sits."""
    flat = v.to(F32).reshape(v.shape[0], -1)
    n = flat.shape[1]
    if n == 1:
        # a lone column takes torch's parallel scan on the card; with two
        # the scan runs down each column
        flat = torch.cat([flat, flat], dim=1)
    return torch.cumsum(flat, dim=0)[-1, :n].reshape(v.shape[1:])


def weighted_lane_sum(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``sum_k w_k x_k`` over the leading axis of x, through `lane_sum`."""
    return lane_sum(w.to(F32).reshape((-1,) + (1,) * (x.ndim - 1))
                    * x.to(F32))
