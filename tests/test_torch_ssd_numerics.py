"""K5's arithmetic on the tensor cores, emulated on the CPU, and its launch
plan.

``csrc/ssd_chunk.cu`` runs both of K5's products (S = C·Bᵀ and y = W·x) as
TF32 tensor-core products split 3xTF32: a = hi + lo with hi = tf32(a) and
lo = tf32(a - hi), summed as lo·hi + hi·lo + hi·hi in fp32.  Here that
arithmetic is emulated in plain PyTorch (TF32 as round-to-nearest, ties away,
to 10 mantissa bits, like ``cvt.rna.tf32.f32``; each product's terms summed
exactly in float64, then rounded to float32) at the serving path's widths
(Q = 256, N = 128, P = 64) and held to ``ssd_chunk_plain`` at the kernel's
tolerance, atol = rtol = 1e-4.  One TF32 product alone misses it, so the
tolerance can tell the two apart.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ssd_chunk as tssd

from test_torch_convert import one_intra_op_thread  # noqa: F401

K5_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _warm_cpu_exp():
    """torch's CPU ``exp`` is now and then off by about 1e-4 on the first
    call in a process (seen with torch 2.13 on AVX512; later calls are
    within 3e-8 of float64).  One call before the comparisons keeps that
    out of them."""
    torch.exp(-torch.rand(2, 4, 256, 256) * 60)


def tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero: add half of the dropped 13 bits' range to the magnitude, then
    clear them."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _product(eq: str, a: torch.Tensor, b: torch.Tensor, terms: int):
    """einsum ``eq`` of float32 a and b as the tensor cores take it: terms=3
    is 3xTF32 (lo·hi + hi·lo + hi·hi), terms=1 one TF32 product (hi·hi)."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    d = lambda u, v: torch.einsum(eq, u.double(), v.double())
    out = d(ah, bh)
    if terms == 3:
        out = out + d(al, bh) + d(ah, bl)
    return out.float()


def ssd_chunk_tensor_cores(x, dt, dA, Bm, Cm, terms: int = 3):
    """K5 as the kernel computes it: S in TF32 products, W = S * exp(cum_i -
    cum_j) * dt_j in float32 (0 above the diagonal), y in TF32 products."""
    M, Q, H, P = x.shape
    hpg = H // Bm.shape[2]
    cum = torch.cumsum(dA, dim=1).transpose(1, 2)                 # (M, H, Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.exp((cum[:, :, :, None] - cum[:, :, None, :]).masked_fill(
        ~causal, float("-inf")))
    S = _product("mqgn,mkgn->mgqk", Cm, Bm, terms)
    W = torch.repeat_interleave(S, hpg, dim=1) * L \
        * dt.transpose(1, 2)[:, :, None, :]
    return _product("mhqk,mkhp->mqhp", W, x, terms)


def _serving_inputs(seed, M, Q, H, P, G, N):
    """As chip_smoke.py draws them: x normal, dt = softplus(normal), dA =
    -0.3 dt, B and C normal times N^-1/4 (scores of unit variance)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, Q, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((M, Q, H)))).astype(np.float32)
    s = N ** -0.25
    B = (r.standard_normal((M, Q, G, N)) * s).astype(np.float32)
    C = (r.standard_normal((M, Q, G, N)) * s).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (x, dt, -0.3 * dt, B, C))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      1 + 2 ** -12, -(1 + 2 ** -11), 3.0e-39, 0.0])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -10, 1 + 2 ** -9, 1.0,
                         -(1 + 2 ** -10), tf32(torch.tensor([3.0e-39]))[0],
                         0.0])
    assert torch.equal(tf32(a), want)
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    hi = tf32(r)
    assert float(((r - hi) / r).abs().max()) <= 2 ** -11
    lo = tf32(r - hi)
    assert float(((r - hi - lo) / r).abs().max()) <= 2 ** -21


@pytest.mark.parametrize("M,H,G,seed", [(2, 4, 1, 0), (1, 4, 2, 1)])
def test_three_tf32_products_hold_the_tolerance_and_one_does_not(M, H, G,
                                                                  seed):
    """At Q = 256, N = 128, P = 64 (mamba2-2.7b's chunk, state and head
    widths) 3xTF32 stays within atol = rtol = 1e-4 of the plain version;
    plain TF32 falls outside it."""
    args = _serving_inputs(seed, M, 256, H, 64, G, 128)
    plain = tssd.ssd_chunk_plain(*args)
    three = ssd_chunk_tensor_cores(*args, terms=3)
    one = ssd_chunk_tensor_cores(*args, terms=1)
    torch.testing.assert_close(three, plain, **K5_TOL)
    assert not torch.allclose(one, plain, **K5_TOL)
    err3 = float((three - plain).abs().max())
    err1 = float((one - plain).abs().max())
    assert err1 > 10 * err3


@pytest.mark.parametrize("M,Q,H,G,N,hs,slices,blocks", [
    (32, 256, 80, 1, 128, 16, 5, 640),    # the (4, 2048) prefill
    (24, 130, 20, 1, 20, 16, 2, 144),     # ragged: slices of 16 and 4 heads
    (16, 130, 20, 1, 20, 8, 3, 144),      # ragged after halving: 8, 8, 4
    (4, 1, 80, 1, 128, 2, 40, 160),       # Q = 1: hs halved to fill the card
    (5, 77, 12, 3, 24, 1, 4, 120),        # G > 1, one head a block
    (40, 256, 32, 2, 64, 16, 1, 320),     # G > 1, a slice per group
])
def test_launch_plan(M, Q, H, G, N, hs, slices, blocks):
    plan = tssd.launch_plan(M, Q, H, G, N)
    assert (plan.heads_per_block, plan.slices, plan.blocks) == (hs, slices,
                                                                blocks)
    assert plan.query_tiles == -(-Q // 64)
    assert plan.slices * plan.heads_per_block >= H // G
    assert (plan.slices - 1) * plan.heads_per_block < H // G
    assert plan.smem_bytes == tssd.smem_bytes(Q, N, hs) <= tssd.SMEM_LIMIT


def test_launch_plan_shared_memory():
    # staging max(3 * 64 * 132, 2 * 64 * 72 + 4096), 4 score tiles of 64 x
    # 68, cum and dt of 16 heads over 256 rows
    assert tssd.smem_bytes(256, 128, 16) == 4 * (25344 + 4 * 64 * 68
                                                 + 2 * 16 * 256)
    assert tssd.smem_bytes(64, 8, 1) == 4 * (2 * 64 * 72 + 4096 + 64 * 68
                                             + 2 * 64)
    # Q = 448 at N = 128 fits with two heads a block, not sixteen; Q = 512
    # not at all
    assert tssd.smem_bytes(448, 128, 3) > tssd.SMEM_LIMIT
    assert tssd.launch_plan(64, 448, 16, 1, 128).heads_per_block == 2
    with pytest.raises(ValueError, match="shared memory"):
        tssd.launch_plan(2, 512, 8, 1, 128)
    # a small card fills with fewer blocks
    assert tssd.launch_plan(4, 1, 80, 1, 128, n_sms=16).heads_per_block == 16
