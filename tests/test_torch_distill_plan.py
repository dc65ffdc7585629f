"""K3's launch plan, and the kernel's partition and combine order emulated
in numpy, on the CPU.

``kernels/distill_loss.launch_plan`` is a pure function.  The CUDA kernel
(``csrc/distill_loss.cu``) gives each long row one block and splits it
into a scalar head up to z's first vector boundary, a vector body and a
scalar tail; each thread takes its vectors a batch at a time (the batch's
max, one rescale, one exp per value); the states (m, l, td, tm) meet in a
butterfly in each warp, then over the warps.  Short rows take L lanes
each.  That partition
is checked to cover every element once with aligned vector loads, and the
arithmetic in that order is held to the plain version, to the reference's
oracle and to its Pallas kernel in interpret mode.  The kernel itself is
held to its plain version on the card (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.distill_loss import distill_loss_fwd_pallas
from repro_torch.kernels import distill_loss as tdl

from test_torch_convert import one_intra_op_thread  # noqa: F401

F32 = np.float32
LOG2E = F32(1.4426950408889634)
VS = [1, 10, 64, 65, 1000, 50_001, 151_936, 151_937]


def _elt(dtype):
    return 4 if dtype == torch.float32 else 2


def _phases(elt):
    """Offsets of z's pointer within 16 bytes: a view at a row offset may
    start anywhere on an element."""
    return (0, elt, 8, 16 - elt)


# ------------------------------------------------------------ the partition --
def row_split(V, elt, vec, phase):
    """(head, body, tail) of a row whose z starts ``phase`` bytes past a
    16-byte boundary, as the kernel computes it."""
    vb = vec * elt
    ph = phase % vb
    head = min(V, (vb - ph) // elt if ph else 0)
    body = (V - head) // vec
    return head, body, V - head - body * vec


def thread_vectors(body, T):
    """(T, k) vector indices of each thread of a block, and which are its."""
    k = max(1, -(-body // T))
    vid = np.arange(T)[:, None] + np.arange(k)[None, :] * T
    return vid, vid < body


def short_lanes(V, L):
    """(L, k) element indices of each lane of a short row, in the order the
    lane takes them (batches of SHORT_BATCH), and which are in the row."""
    nb = -(-V // (tdl.SHORT_BATCH * L))
    cid = np.arange(L)[:, None] + np.arange(nb * tdl.SHORT_BATCH)[None, :] * L
    return cid, cid < V


def row_elements(plan, V, elt, phase):
    """Every element index a row's threads load, once per load, and the
    byte offsets (from z's 16-byte boundary) of its vector loads."""
    if plan.lanes < 32:
        cid, ok = short_lanes(V, plan.lanes)
        return cid[ok], np.zeros(0, np.int64)
    head, body, tail = row_split(V, elt, plan.vec, phase)
    vid, ok = thread_vectors(body, plan.threads)
    v = vid[ok]
    idx = [np.arange(head), head + body * plan.vec + np.arange(tail),
           (head + v[:, None] * plan.vec + np.arange(plan.vec)).ravel()]
    return np.concatenate(idx), phase + (head + v * plan.vec) * elt


@pytest.mark.parametrize("V", VS)
@pytest.mark.parametrize("N", [1, 333, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ptr_align", [256, 8, "one element"])
def test_launch_plan_covers_every_element_once(V, N, dtype, ptr_align):
    elt = _elt(dtype)
    if ptr_align == "one element":
        ptr_align = elt
    plan = tdl.launch_plan(N, V, dtype, ptr_align)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= tdl.THREADS
    vb = plan.vec * elt
    assert vb <= 16 and ptr_align % vb == 0
    if plan.lanes < 32:                                # short rows
        assert V <= tdl.SHORT_V and plan.vec == 1
        assert plan.lanes * tdl.SHORT_BATCH >= V
        assert plan.threads % plan.lanes == 0          # whole rows a block
    else:                                              # one block a row
        assert plan.lanes == plan.threads
    for phase in _phases(elt):
        for n in sorted({0, 1, 2, N - 1} & set(range(N))):
            row_phase = (phase + n * V * elt) % 16
            idx, starts = row_elements(plan, V, elt, row_phase)
            assert np.array_equal(np.bincount(idx, minlength=V),
                                  np.ones(V, np.int64))  # each element once
            assert (starts % vb == 0).all()                       # z aligned
            assert ((starts + ptr_align) % vb == 0).all()         # t aligned


def test_launch_plan_main_shapes():
    """(333, 50001) f32 and (2048, 151936) bf16: 16-byte loads, 256 threads
    a row, 32 KB of loads a block in flight; (100, 10) f32: 4 lanes a row, 8
    rows a warp, 13 blocks; short bodies take fewer threads."""
    p = tdl.launch_plan(333, 50_001)
    assert (p.vec, p.lanes, p.threads) == (4, 256, 256)
    assert p.threads * 2 * tdl.BATCH_BYTES == 32 * 1024
    p = tdl.launch_plan(2048, 151_936, torch.bfloat16)
    assert (p.vec, p.lanes, p.threads) == (8, 256, 256)
    p = tdl.launch_plan(100, 10)
    assert (p.vec, p.lanes, p.threads) == (1, 4, 32)
    assert -(-100 // (p.threads // p.lanes)) == 13
    assert tdl.launch_plan(8, 1000).threads == 64     # 250 vectors, 4 a thread
    assert tdl.launch_plan(333, 50_001, ptr_align=4).vec == 1   # t one float off


def test_pointer_align():
    buf = torch.zeros(64)
    assert tdl.pointer_align(buf[:8], buf[32:40]) == 128
    assert tdl.pointer_align(buf[:8], buf[1:9]) == 4
    assert tdl.pointer_align(buf[:8], buf[:8]) == 256


# ------------------------------------------------ the arithmetic, emulated --
class St:
    """States (m, l, td, tm) of parallel threads, float32 arrays."""

    def __init__(self, shape):
        self.m = np.full(shape, -np.inf, F32)
        self.l, self.td, self.tm = (np.zeros(shape, F32) for _ in range(3))

    def take(self, idx):
        s = St(0)
        s.m, s.l, s.td, s.tm = (a[idx] for a in (self.m, self.l, self.td,
                                                  self.tm))
        return s


def absorb(s, z, t, valid):
    """csrc's ``absorb``: z, t, valid (P, K); invalid values are zeros kept
    out of the max and the sum of exp."""
    with np.errstate(invalid="ignore", over="ignore"):
        mb = np.where(valid, z, -np.inf).max(axis=1).astype(F32)
        mn = np.maximum(s.m, mb)
        ms = np.where(mn == -np.inf, F32(0), mn)
        l = s.l * np.exp2((s.m - ms) * LOG2E)
        for i in range(z.shape[1]):
            e = np.exp2((z[:, i] - ms) * LOG2E)
            l = l + np.where(valid[:, i], e, F32(0))
            s.td = s.td + t[:, i] * z[:, i]      # one fma in the kernel
            s.tm = s.tm + t[:, i]
    s.m, s.l = mn, l.astype(F32)


def combine(a, b):
    with np.errstate(invalid="ignore", over="ignore"):
        m = np.maximum(a.m, b.m)
        x = np.where(a.l == 0, F32(0), a.l * np.exp(a.m - m))
        y = np.where(b.l == 0, F32(0), b.l * np.exp(b.m - m))
    a.m, a.l = m, (x + y).astype(F32)
    a.td, a.tm = a.td + b.td, a.tm + b.tm


def butterfly(s, L):
    """csrc's ``group_combine`` over the last axis in groups of L lanes."""
    lanes = np.arange(s.m.shape[-1])
    o = L // 2
    while o:
        combine(s, s.take((..., lanes ^ o)))
        o //= 2


def block_state(s, T):
    """Thread states (T,) -> the block's: warps, then warp 0 over them."""
    w = St((T // 32, 32))
    for a in ("m", "l", "td", "tm"):
        setattr(w, a, getattr(s, a).reshape(T // 32, 32))
    butterfly(w, 32)
    top = St(32)
    for a in ("m", "l", "td", "tm"):
        getattr(top, a)[:T // 32] = getattr(w, a)[:, 0]
    butterfly(top, 32)
    return top.take(slice(0, 1))


def emulate_row(z, t, plan, elt, phase):
    """One row of z, t (V,) float32 whose z starts ``phase`` bytes past a
    16-byte boundary -> (loss, logZ) in the kernel's order."""
    V = z.size
    if plan.lanes < 32:
        cid, ok = short_lanes(V, plan.lanes)
        s = St(plan.lanes)
        c = np.where(ok, cid, 0)
        zz = np.where(ok, z[c], 0).astype(F32)
        tt = np.where(ok, t[c], 0).astype(F32)
        for b in range(0, cid.shape[1], tdl.SHORT_BATCH):
            sl = slice(b, b + tdl.SHORT_BATCH)
            absorb(s, zz[:, sl], tt[:, sl], ok[:, sl])
        butterfly(s, plan.lanes)
        st = s.take(slice(0, 1))
    else:
        T, vec = plan.threads, plan.vec
        head, body, tail = row_split(V, elt, vec, phase)
        U = tdl.BATCH_BYTES // (vec * elt)
        s = St(T)
        for first, count in ((0, head), (head + body * vec, tail)):
            if count:                 # threads below count take one element
                sel = (np.arange(T) < count)[:, None]
                i = first + np.minimum(np.arange(T), count - 1)[:, None]
                absorb(s, np.where(sel, z[i], 0).astype(F32),
                       np.where(sel, t[i], 0).astype(F32), sel)
        vid, ok = thread_vectors(body, T)
        e = head + np.where(ok, vid, 0)[..., None] * vec + np.arange(vec)
        okv = np.repeat(ok, vec, axis=1)
        zz = np.where(okv, z[e].reshape(T, -1), 0).astype(F32)
        tt = np.where(okv, t[e].reshape(T, -1), 0).astype(F32)
        for b in range(0, vid.shape[1], U):
            sl = slice(b * vec, (b + U) * vec)
            absorb(s, zz[:, sl], tt[:, sl], okv[:, sl])
        st = block_state(s, T)
    lz = (st.m + np.log(st.l)).astype(F32)[0]
    return F32(st.tm[0] * lz - st.td[0]), lz


def emulate(z, t, plan, elt=4, phase=0):
    """(N, V) float32 values -> (loss, logZ) (N,): the kernel's partition
    and combine order for elements of ``elt`` bytes (bf16 values widened,
    as the kernel's loads do) with z starting ``phase`` bytes past a
    16-byte boundary."""
    out = [emulate_row(z[n], t[n], plan, elt,
                       (phase + n * z.shape[1] * elt) % 16)
           for n in range(z.shape[0])]
    return (np.array([o[0] for o in out], F32),
            np.array([o[1] for o in out], F32))


def _zt(seed, N, V):
    r = np.random.default_rng(seed)
    z = (r.standard_normal((N, V)) * 4).astype(F32)
    x = r.standard_normal((N, V)).astype(F32)
    e = np.exp(x - x.max(-1, keepdims=True))
    return z, (e / e.sum(-1, keepdims=True)).astype(F32)


@pytest.mark.parametrize("N,V", [(2, 151_936), (2, 151_937), (3, 50_001),
                                 (4, 1000), (5, 65), (100, 10), (7, 64),
                                 (3, 1)])
@pytest.mark.parametrize("phase", [0, 4, 12])
def test_emulated_kernel_matches_plain_and_ref(N, V, phase):
    """f32 rows at pointer phases 0, 4 and 12 bytes: the emulated kernel
    against the plain version and the reference's oracle, atol 1e-4 and
    rtol 1e-3 (the reference's tolerance for K3)."""
    z, t = _zt(N + V, N, V)
    plan = tdl.launch_plan(N, V)
    loss, logz = emulate(z, t, plan, 4, phase)
    ploss, plogz = tdl.distill_loss_fwd_plain(torch.from_numpy(z),
                                              torch.from_numpy(t))
    np.testing.assert_allclose(loss, ploss.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(logz, plogz.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(
        loss, np.asarray(jax.jit(jref.distill_loss_ref)(z, t)),
        atol=1e-4, rtol=1e-3)


def _error_vs_float64(out, z, t):
    """The largest error in (loss, logZ) against float64 values of z, t."""
    zd, td = z.astype(np.float64), t.astype(np.float64)
    m = zd.max(-1, keepdims=True)
    lz = (m + np.log(np.exp(zd - m).sum(-1, keepdims=True)))[:, 0]
    exact = (td.sum(-1) * lz - (td * zd).sum(-1), lz)
    return max(float(np.abs(np.asarray(o, np.float64) - e).max())
               for o, e in zip(out, exact))


@pytest.mark.parametrize("fault", ["head", "tail", "body vector",
                                   "short row"])
def test_float64_check_catches_a_missing_element(fault):
    """The card's check of K3 (tests/test_torch_cuda.py, chip_smoke.py):
    its error against float64 at most twice the plain version's.  The
    emulated kernel passes it; the emulated kernel with one element of
    every row left out of its sums (the first of the head, the last of the
    tail, a vector in the body, one of a short row's) fails it.  For long
    rows atol 1e-4, rtol 1e-3 against the plain version alone would pass
    that fault."""
    # torch's first CPU exp in a process may be off (test_torch_ssd_numerics)
    torch.exp(-torch.rand(256, 256) * 60)
    N, V, phase = (100, 10, 0) if fault == "short row" else (4, 50_001, 4)
    z, t = _zt(17, N, V)
    plan = tdl.launch_plan(N, V)
    drop = {"head": 0, "tail": V - 1, "body vector": slice(400, 404),
            "short row": 5}[fault]
    keep = np.delete(np.arange(V), drop)
    clean = emulate(z, t, plan, 4, phase)
    faulty = [emulate(z[n:n + 1, keep], t[n:n + 1, keep], plan, 4,
                      (phase + n * V * 4) % 16) for n in range(N)]
    faulty = tuple(np.concatenate(o) for o in zip(*faulty))
    plain = [a.numpy() for a in tdl.distill_loss_fwd_plain(
        torch.from_numpy(z), torch.from_numpy(t))]
    e_plain = _error_vs_float64(plain, z, t)
    assert _error_vs_float64(clean, z, t) <= 2 * e_plain
    assert _error_vs_float64(faulty, z, t) > 2 * e_plain
    if fault != "short row":
        np.testing.assert_allclose(faulty[0], plain[0], atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("N,V,bn,bv", [(8, 64, 8, 16), (16, 1024, 8, 256),
                                       (32, 10, 8, 10)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_emulated_kernel_matches_pallas_interpret(N, V, bn, bv, dtype):
    """The emulated kernel on the same values as the reference's Pallas
    kernel in interpret mode (bf16 values widened to f32, as both kernels
    load them), atol 1e-4, rtol 1e-3."""
    z, t = _zt(N * V, N, V)
    zj, tj = jnp.asarray(z), jnp.asarray(t)
    if dtype == "bf16":
        zj, tj = zj.astype(jnp.bfloat16), tj.astype(jnp.bfloat16)
        z, t = (np.asarray(a.astype(jnp.float32)) for a in (zj, tj))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    loss, logz = emulate(z, t, tdl.launch_plan(N, V, tdt), _elt(tdt))
    ploss, plogz = distill_loss_fwd_pallas(zj, tj, block_n=bn, block_v=bv,
                                           interpret=True)
    np.testing.assert_allclose(loss, np.asarray(ploss), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(logz, np.asarray(plogz), atol=1e-4, rtol=1e-3)
