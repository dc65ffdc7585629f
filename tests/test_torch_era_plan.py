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

from test_torch_convert import one_intra_op_thread  # noqa: F401

F32 = np.float32
SHAPES = [(100, 1000, 10), (100, 1000, 46), (10, 256, 32768), (3, 13, 151),
          (1, 1, 10), (3, 1, 10), (1, 13, 46), (3, 100, 151), (1000, 1000, 10),
          (1, 100_000, 10), (7, 37, 10), (2, 5, 3000), (1, 1, 58_000),
          (4, 9, 12), (10, 1000, 46), (10, 1000, 2), (3, 13, 2)]


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
                                   (2, 1, 10), (37, 9, 12), (10, 100, 2)])
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


# ------------------------------------------------------ the wide-row route --
WIDE_C = [58_080, 58_081, 100_352, 151_936, 256_000]


def _thread_values(C, vec, row_offset, threads=tes.WIDE_THREADS):
    """(threads, L) value indices of one row in each thread's order on the
    wide route (csrc ``walk``: its head value, its vectors g = t, t + T,
    ..., its tail value), -1 where a thread has none."""
    head, nvec, tail = tes.wide_row_split(C, vec, row_offset)
    t = np.arange(threads)[:, None]
    per = -(-nvec // threads)
    g = t + threads * np.arange(per)[None, :]                  # (T, per)
    vecs = head + g[:, :, None] * vec + np.arange(vec)         # (T, per, V)
    vecs = np.where((g < nvec)[:, :, None], vecs, -1).reshape(threads, -1)
    cols = [np.where(t < head, t, -1), vecs,
            np.where(t < tail, head + nvec * vec + t, -1)]
    return np.concatenate(cols, axis=1)


@pytest.mark.parametrize("C", WIDE_C)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ptr_align", [256, "one element"])
def test_wide_route_exactly_where_a_row_does_not_fit(C, dtype, ptr_align):
    """The narrow plan holds a row of C f32 values in shared memory up to C
    = SMEM_BYTES / 4 = 58,080; past it launch_plan takes the wide route,
    one block a row.  Every client's row of N*C-aligned loads sits at the
    same offset from a vector boundary, and the threads' head, vectors and
    tail cover each value of a row exactly once, with aligned vectors."""
    elt = _elt(dtype)
    off = 0 if ptr_align == 256 else 1            # elements past 256 bytes
    K, N = 3, 13
    plan = tes.launch_plan(K, N, C, dtype, 256 if off == 0 else elt)
    assert plan.wide == (C * 4 > tes.SMEM_BYTES) == (C > 58_080)
    if not plan.wide:
        assert plan.smem_bytes + 32 * 4 <= 232_448
        return
    V = plan.vec
    assert (plan.blocks, plan.threads, plan.smem_bytes) == (N, 512, 0)
    assert V * elt <= 16 and (N * C) % V == 0
    assert plan.reread == (K * elt <= 8)
    assert plan.args() == (V, 512, int(plan.reread))
    for n in (0, 1, N - 1):
        splits = {tes.wide_row_split(C, V, off + k * N * C + n * C)
                  for k in range(K)}
        assert len(splits) == 1                   # every client cut alike
        head, nvec, tail = splits.pop()
        assert head < V and tail < V and head + nvec * V + tail == C
        assert (off + n * C + head) % V == 0      # vectors start aligned
        idx = _thread_values(C, V, off + n * C)
        seen = np.sort(idx[idx >= 0])
        np.testing.assert_array_equal(seen, np.arange(C))


def test_wide_plan_at_the_llm_round():
    """qwen1.5-4b's (2, 1024, 151936) bf16 uploads: 16-byte loads, a block a
    row, and pass 2 sums the 4 bytes of inputs again rather than storing
    and rereading 8 bytes of sums; a K=3 f32 stack stores them instead."""
    plan = tes.launch_plan(2, 1024, 151_936, torch.bfloat16)
    assert (plan.wide, plan.vec, plan.blocks, plan.reread) == (True, 8, 1024,
                                                               True)
    assert plan.inflight_bytes_per_sm >= 24 * 1024
    assert not tes.launch_plan(3, 1024, 151_936).reread


def _merge(m, l, m2, l2):
    """csrc merge_ml, elementwise in float32 (every product and sum rounded
    on its own)."""
    mm = np.maximum(m, m2)
    empty = mm == -np.inf
    with np.errstate(invalid="ignore"):
        new_l = (l * np.exp(m - mm)) + (l2 * np.exp(m2 - mm))
    return np.where(empty, m, mm), np.where(empty, l, new_l).astype(F32)


def _butterfly(m, l):
    """The xor butterfly of each warp of 32 lanes; every lane ends equal."""
    lanes = np.arange(m.shape[0])
    for o in (16, 8, 4, 2, 1):
        m, l = _merge(m, l, m[lanes ^ o], l[lanes ^ o])
    return m, l


def emulate_wide(p, w, temperature, vec, sharpen=True, elem_offset=0,
                 threads=tes.WIDE_THREADS):
    """csrc/era_sharpen.cu's wide route in numpy float32: each value's
    client sum in the narrow route's order (S = 1), then per row each
    thread's online (max, sum of exp) over its values in order, the warps'
    butterflies, warp 0's over the warps, and exp(s - m) / l."""
    K, N, C = p.shape
    p = p.astype(F32)
    s = np.zeros((N, C), F32)
    for k in range(K):
        s = s + (p[k] if w is None else F32(w[k]) * p[k])
    if w is None:
        s = s * F32(1.0 / K)
    if not sharpen:
        return s
    s = s * F32(1.0 / temperature)
    out = np.empty_like(s)
    for n in range(N):
        idx = _thread_values(C, vec, elem_offset + n * C, threads)
        m = np.full(threads, -np.inf, F32)
        l = np.zeros(threads, F32)
        for j in range(idx.shape[1]):
            live = idx[:, j] >= 0
            x = np.where(live, s[n][idx[:, j]], F32(0))
            with np.errstate(invalid="ignore", over="ignore"):
                up = live & (x > m)
                l_up = (l * np.exp(m - x)) + F32(1)
                l_add = l + np.exp(x - m)
            l = np.where(up, l_up, np.where(live, l_add, l)).astype(F32)
            m = np.where(up, x, m).astype(F32)
        m, l = zip(*(_butterfly(m[i:i + 32], l[i:i + 32])
                     for i in range(0, threads, 32)))
        wm = np.full(32, -np.inf, F32)
        wl = np.zeros(32, F32)
        wm[:len(m)] = [v[0] for v in m]
        wl[:len(l)] = [v[0] for v in l]
        wm, wl = _butterfly(wm, wl)
        out[n] = np.exp(s[n] - wm[0]) / wl[0]
    return out


def _peaked(seed, shape):
    """Probabilities with one class of 0.9 a row (the clients agree on it),
    so the T = 0.1 softmax over a vocabulary-wide row is not flat."""
    K, N, C = shape
    rng = np.random.default_rng(seed)
    p = 0.1 * _probs(seed, shape)
    p[:, np.arange(N), rng.integers(0, C, N)] += 0.9
    return p.astype(F32)


@pytest.mark.parametrize("K,N,C,dtype,off", [
    (2, 3, 151_936, torch.float32, 0), (2, 3, 151_936, torch.float32, 1),
    (3, 2, 58_081, torch.bfloat16, 3), (1, 2, 100_352, torch.float32, 0)])
def test_wide_emulation_matches_plain(K, N, C, dtype, off):
    p = _peaked(C + K, (K, N, C))
    pt = torch.from_numpy(p).to(dtype)
    p = pt.float().numpy()
    w = np.random.default_rng(K).uniform(size=K).astype(F32)
    w = (w / w.sum()).astype(F32)
    V = tes.launch_plan(K, N, C, dtype).vec
    wt = torch.from_numpy(w)
    k1 = emulate_wide(p, None, 0.1, V, elem_offset=off)
    assert k1.max() > 0.01                 # the check is not on flat rows
    np.testing.assert_allclose(k1, tes.era_sharpen_plain(pt, 0.1).numpy(),
                               atol=1e-6, rtol=0)
    for sharpen in (True, False):
        np.testing.assert_allclose(
            emulate_wide(p, w, 0.1, V, sharpen, elem_offset=off),
            tes.weighted_era_sharpen_plain(pt, wt, 0.1, sharpen).numpy(),
            atol=1e-6, rtol=0)


def test_wide_emulation_matches_pallas_and_ref():
    """At (2, 3, 151936) f32, the reference's Pallas kernels in interpret
    mode (which keep the whole row in VMEM) and its jnp oracles."""
    from repro.kernels import ref
    p = _peaked(5, (2, 3, 151_936))
    w = np.array([0.3, 0.7], F32)
    V = tes.launch_plan(2, 3, 151_936).vec
    k1 = emulate_wide(p, None, 0.1, V)
    for theirs in (era_sharpen_pallas(jnp.asarray(p), 0.1, interpret=True),
                   ref.era_sharpen_ref(jnp.asarray(p), 0.1)):
        np.testing.assert_allclose(k1, np.asarray(theirs), atol=1e-6, rtol=0)
    for sharpen in (True, False):
        k2 = emulate_wide(p, w, 0.1, V, sharpen)
        for theirs in (weighted_era_sharpen_pallas(
                jnp.asarray(p), jnp.asarray(w), 0.1, sharpen=sharpen,
                interpret=True),
                ref.weighted_era_sharpen_ref(jnp.asarray(p), jnp.asarray(w),
                                             0.1, sharpen)):
            np.testing.assert_allclose(k2, np.asarray(theirs), atol=1e-6,
                                       rtol=0)


def test_wide_emulation_zero_weight_changes_no_bit():
    p = _peaked(9, (3, 2, 151_936))
    garbage = p.copy()
    garbage[0], garbage[2] = 1e30, -1e30
    w = np.array([0.0, 1.0, 0.0], F32)
    for sharpen in (True, False):
        np.testing.assert_array_equal(
            emulate_wide(p, w, 0.1, 4, sharpen),
            emulate_wide(garbage, w, 0.1, 4, sharpen))
