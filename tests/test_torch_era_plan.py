"""K1/K2's launch plan, and the kernel's documented summation order
emulated in numpy, on the CPU.

``kernels/era_sharpen.launch_plan`` is a pure function: the grid must cover
every output row once, the shared memory must fit a block, the main shape
must keep enough loads in flight, and unaligned shapes must take narrower
loads.  The CUDA kernel (``csrc/era_sharpen.cu``) sums each slice of the
client axis in order in fp32, each term rounded as w_k * p_k before it is
added, then adds the slices' sums in order; that order is emulated here
and held to the plain version and to the reference's Pallas kernel in
interpret mode, and a zero-weight client of +-1e30 rows changes no bit
under it.  The kernel itself is held to its plain version on the card
(tests/test_torch_cuda.py).
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.era_sharpen import (era_sharpen_pallas,
                                       weighted_era_sharpen_pallas)
from repro_torch.kernels import era_sharpen as tes

F32 = np.float32
SHAPES = [(100, 1000, 10), (100, 1000, 46), (10, 256, 32768), (3, 13, 151),
          (1, 1, 10), (3, 1, 10), (1, 13, 46), (3, 100, 151), (1000, 1000, 10),
          (1, 100_000, 10), (7, 37, 10), (2, 5, 3000), (1, 1, 58_000),
          (4, 9, 12)]


def _elt(dtype):
    return 4 if dtype == torch.float32 else 2


@pytest.mark.parametrize("K,N,C", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ptr_align", [256, 8, "one element"])
def test_launch_plan_covers_rows_and_fits(K, N, C, dtype, ptr_align):
    if ptr_align == "one element":
        ptr_align = _elt(dtype)
    plan = tes.launch_plan(K, N, C, dtype, ptr_align)
    R = plan.rows
    starts = [b * R for b in range(plan.blocks)]
    covered = [n for n0 in starts for n in range(n0, min(n0 + R, N))]
    assert covered == list(range(N))                 # each row exactly once
    assert plan.smem_bytes == plan.slices * R * C * 4
    assert plan.smem_bytes + 32 * 4 <= 232_448       # with the reduction scratch
    assert plan.threads % 32 == 0 and plan.threads <= tes.MAX_THREADS
    assert 1 <= plan.slices <= K
    assert plan.slices * plan.group_threads <= plan.threads
    vb = plan.vec * _elt(dtype)
    assert vb <= 16 and ptr_align % vb == 0
    assert (N * C) % plan.vec == 0 and (R * C) % plan.vec == 0


def test_launch_plan_main_shape():
    """The DS-FL round's (100, 1000, 10) f32: 4-row tiles of 16 KB, 250
    blocks (about 2 an SM), 16-byte loads, every thread busy, and at least
    24 KB of loads in flight on each SM."""
    plan = tes.launch_plan(100, 1000, 10)
    assert (plan.rows, plan.vec, plan.blocks) == (4, 4, 250)
    assert (plan.slices, plan.threads) == (25, 256)     # 10 vectors x 25 slices
    assert plan.blocks >= 1.5 * tes.H100_SMS
    assert plan.inflight_bytes_per_sm >= 24 * 1024
    wide = tes.launch_plan(10, 256, 32768)
    assert (wide.rows, wide.vec, wide.slices) == (1, 4, 1)
    assert wide.inflight_bytes_per_sm >= 24 * 1024


@pytest.mark.parametrize("K,N,C,dtype,ptr_align,vec", [
    (100, 1000, 10, torch.float32, 256, 4),
    (100, 1000, 10, torch.float32, 8, 2),
    (100, 1000, 10, torch.float32, 4, 1),
    (3, 13, 151, torch.bfloat16, 256, 1),    # N*C*2 = 3,926 B: 2-byte loads
    (3, 13, 151, torch.float32, 256, 1),
    (3, 100, 46, torch.bfloat16, 256, 8),
    (1, 13, 10, torch.float32, 256, 2),      # N*C = 130: 8-byte loads
    (2, 3, 32767, torch.bfloat16, 256, 1)])
def test_launch_plan_aligned_or_unaligned(K, N, C, dtype, ptr_align, vec):
    plan = tes.launch_plan(K, N, C, dtype, ptr_align)
    assert plan.vec == vec
    assert plan.rows % (vec // math.gcd(vec, C)) == 0


# ----------------------------------------------- the kernel's summation order --
def emulate(p, w, plan, temperature, sharpen=True):
    """csrc/era_sharpen.cu's arithmetic in numpy float32.  ``w`` None is K1
    (plain sum, then 1/K); the aggregate of each value does not depend on
    the row tiling, only on the slices."""
    K, S = p.shape[0], plan.slices
    p = p.astype(F32)
    x = []
    for s in range(S):
        acc = np.zeros(p.shape[1:], F32)                       # +0
        for k in range(s * K // S, (s + 1) * K // S):
            acc = acc + (p[k] if w is None else F32(w[k]) * p[k])
        x.append(acc)
    x = functools.reduce(lambda a, b: a + b, x)      # slices in order
    if w is None:
        x = x * F32(1.0 / K)
    if not sharpen:
        return x
    x = x * F32(1.0 / temperature)
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True, dtype=F32)


def _probs(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(F32) * 2
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(F32)


@pytest.mark.parametrize("K,N,C", [(100, 40, 10), (10, 100, 46), (3, 13, 151),
                                   (2, 1, 10), (37, 9, 12)])
def test_emulated_order_matches_plain_and_pallas(K, N, C):
    p = _probs(K + N + C, (K, N, C))
    w = np.random.default_rng(C).uniform(size=K).astype(F32)
    w[0] = 0.0
    w = (w / w.sum()).astype(F32)
    plan = tes.launch_plan(K, N, C)
    pt, wt = torch.from_numpy(p), torch.from_numpy(w)
    k1 = emulate(p, None, plan, 0.1)
    np.testing.assert_allclose(k1, tes.era_sharpen_plain(pt, 0.1).numpy(),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        k1, np.asarray(era_sharpen_pallas(jnp.asarray(p), 0.1,
                                          interpret=True)), atol=1e-6, rtol=0)
    for sharpen in (True, False):
        k2 = emulate(p, w, plan, 0.1, sharpen)
        np.testing.assert_allclose(
            k2, tes.weighted_era_sharpen_plain(pt, wt, 0.1, sharpen).numpy(),
            atol=1e-6, rtol=0)
        np.testing.assert_allclose(
            k2, np.asarray(weighted_era_sharpen_pallas(
                jnp.asarray(p), jnp.asarray(w), 0.1, sharpen=sharpen,
                interpret=True)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("K,N,C,zeros", [(4, 9, 12, (0, 3)),
                                         (100, 20, 10, (0, 5, 6, 7, 50, 99))])
def test_emulated_order_zero_weight_changes_no_bit(K, N, C, zeros):
    p = _probs(7, (K, N, C))
    garbage = p.copy()
    for i, z in enumerate(zeros):
        garbage[z] = 1e30 if i % 2 == 0 else -1e30
    w = np.random.default_rng(8).uniform(size=K).astype(F32)
    w[list(zeros)] = 0.0
    w = (w / w.sum()).astype(F32)
    plan = tes.launch_plan(K, N, C)
    assert plan.slices > 1          # zero-weight clients fall in several slices
    for sharpen in (True, False):
        np.testing.assert_array_equal(emulate(p, w, plan, 0.1, sharpen),
                                      emulate(garbage, w, plan, 0.1, sharpen))
