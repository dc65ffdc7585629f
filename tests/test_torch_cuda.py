"""The CUDA kernels K1-K5 against their plain versions, on the card, and
the serving path's launches of K5.

Every test here is marked ``cuda`` and skips (from its fixture) where torch
sees no card.  The file imports nothing of JAX, so on a machine without it
the tests run with

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import aggregation
from repro_torch.kernels import _build, ops
from repro_torch.kernels import distill_loss as tdl
from repro_torch.kernels import era_sharpen as tes
from repro_torch.kernels import ssd_chunk as tssd

ATOL_ERA = {torch.float32: 1e-6, torch.bfloat16: 5e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def _probs(device, shape, seed, dtype=torch.float32, scale=2.0):
    x = torch.randn(shape, generator=_gen(device, seed), device=device)
    return torch.softmax(x * scale, dim=-1).to(dtype)


def _weights(device, K, seed):
    w = torch.rand((K,), generator=_gen(device, seed), device=device)
    w[0] = 0.0
    return w / w.sum()


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,C,dtype", [(100, 1000, 10, torch.float32),
                                         (3, 13, 151, torch.bfloat16),
                                         (2, 1, 10, torch.float32),
                                         (4, 7, 20_000, torch.float32)])
def test_era_kernels_match_plain(cuda_device, K, N, C, dtype):
    p = _probs(cuda_device, (K, N, C), K + N + C, dtype)
    w = _weights(cuda_device, K, K)
    atol = ATOL_ERA[dtype]
    pairs = ((tes.era_sharpen(p, 0.1), tes.era_sharpen_plain(p, 0.1)),
             (tes.weighted_era_sharpen(p, w, 0.1),
              tes.weighted_era_sharpen_plain(p, w, 0.1)),
             (tes.weighted_era_sharpen(p, w, sharpen=False),
              tes.weighted_era_sharpen_plain(p, w, sharpen=False)))
    torch.cuda.synchronize()
    for out, exp in pairs:
        assert out.dtype == torch.float32 and out.shape == (N, C)
        torch.testing.assert_close(out, exp, atol=atol, rtol=0)


@pytest.mark.cuda
def test_zero_weight_client_changes_no_bit(cuda_device):
    p = _probs(cuda_device, (4, 9, 12), 3)
    garbage = p.clone()
    garbage[0], garbage[3] = 1e30, -1e30
    w = torch.tensor([0.0, 0.5, 0.5, 0.0], device=cuda_device)
    a = tes.weighted_era_sharpen(p, w, 0.1)
    b = tes.weighted_era_sharpen(garbage, w, 0.1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,dtype", [(100, 10, torch.float32),
                                       (37, 1000, torch.float32),
                                       (64, 4096, torch.bfloat16)])
def test_distill_kernels_match_plain(cuda_device, N, V, dtype):
    g = _gen(cuda_device, N + V)
    z = (torch.randn((N, V), generator=g, device=cuda_device) * 4).to(dtype)
    t = _probs(cuda_device, (N, V), N, dtype, scale=1.0)
    loss, logz = tdl.distill_loss_fwd(z, t)
    ploss, plogz = tdl.distill_loss_fwd_plain(z, t)
    torch.cuda.synchronize()
    atol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(loss, ploss, atol=atol, rtol=1e-3)
    torch.testing.assert_close(logz, plogz, atol=atol, rtol=1e-3)
    tmass = t.float().sum(-1)
    gscale = torch.tensor([1.0 / N], device=cuda_device)
    dz = tdl.distill_loss_bwd(z, t, plogz, tmass, gscale)
    exp = tdl.distill_loss_bwd_plain(z, t, plogz, tmass, gscale)
    torch.cuda.synchronize()
    assert dz.dtype == dtype
    # bf16: every |dz| is at most gscale, so the tolerance scales with it;
    # rtol is one bf16 rounding step (2^-7) of the value
    atol, rtol = ((1e-6 / N, 1e-2) if dtype == torch.bfloat16 else (1e-6, 0.0))
    torch.testing.assert_close(dz.float(), exp.float(), atol=atol, rtol=rtol)
    assert not torch.allclose(torch.zeros_like(exp.float()), exp.float(),
                              atol=atol, rtol=rtol), "a zeroed dz would pass"


@pytest.mark.cuda
def test_distill_loss_autograd_on_the_card(cuda_device):
    """The autograd Function (K3 forward, K4 backward) against autograd of
    the plain loss, atol 1e-5."""
    g = _gen(cuda_device, 5)
    z = torch.randn((64, 256), generator=g, device=cuda_device) * 3
    t = _probs(cuda_device, (64, 256), 6, scale=1.0)
    zk = z.clone().requires_grad_(True)
    ops.distill_loss_2d.apply(zk, t).backward()
    zp = z.clone().requires_grad_(True)
    tdl.distill_loss_fwd_plain(zp, t)[0].mean().backward()
    torch.cuda.synchronize()
    torch.testing.assert_close(zk.grad, zp.grad, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_aggregation_routes_to_kernels_and_counts(cuda_device):
    p = _probs(cuda_device, (4, 8, 10), 9)
    w = torch.tensor([1.0, 2.0, 0.0, 1.0], device=cuda_device)
    _build.reset_launches()
    aggregation.era(p, 0.1, use_kernel=True)
    aggregation.weighted_era(p, w, 0.1, use_kernel=True)
    aggregation.weighted_sa(p, w, use_kernel=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["era_sharpen"] == 1
    assert _build.LAUNCHES["weighted_era_sharpen"] == 2
    with pytest.raises(ValueError, match="dtype"):
        tes.era_sharpen(p.double(), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        tes.era_sharpen(p.transpose(1, 2), 0.1)
    assert np.isfinite(aggregation.era(p, 0.1, True).cpu().numpy()).all()


# ---------------------------------------------------------------------- K5 --
def _ssd_inputs(device, M, Q, H, P, G, N, seed):
    """As chip_smoke.py draws them: B and C scaled by N^-1/4, so the scores
    C.B have unit variance at every N."""
    g = _gen(device, seed)
    rn = lambda *shape: torch.randn(shape, generator=g, device=device)
    x = rn(M, Q, H, P)
    dt = torch.nn.functional.softplus(rn(M, Q, H))
    s = N ** -0.25
    return x, dt, -0.3 * dt, rn(M, Q, G, N) * s, rn(M, Q, G, N) * s


@pytest.mark.cuda
@pytest.mark.parametrize("M,Q,H,P,G,N", [
    (32, 256, 80, 64, 1, 128),      # mamba2-2.7b, a (4, 2048) prefill
    (4, 1, 80, 64, 1, 128),         # the bucket-1 prefill
    (3, 100, 80, 64, 1, 128),       # a ragged chunk
    (5, 77, 12, 40, 3, 24),         # G > 1, ragged P and N
    (2, 130, 8, 96, 2, 64),         # two P tiles, three query tiles
    (24, 130, 20, 40, 1, 20),       # head slices of 16 and 4; N, P not 8k
    (3, 70, 6, 37, 2, 13),          # rows not 16-byte aligned (4-byte copies)
    (1, 1, 12, 40, 3, 20)])         # Q = 1 with G > 1
def test_ssd_chunk_kernel_matches_plain(cuda_device, M, Q, H, P, G, N):
    """K5 against its plain version at chip_smoke.py's shapes, atol = rtol
    = 1e-4 (the reference's tolerance); the kernel's shared memory is the
    wrapper's plan's, and one call is one launch."""
    args = _ssd_inputs(cuda_device, M, Q, H, P, G, N, M + Q)
    plan = tssd.launch_plan(M, Q, H, G, N, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count)
    assert tssd._lib().ssd_chunk_smem_bytes(
        Q, N, plan.heads_per_block) == plan.smem_bytes
    _build.reset_launches()
    y = tssd.ssd_chunk(*args)
    exp = tssd.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ssd_chunk"] == 1
    assert y.shape == (M, Q, H, P) and bool(torch.isfinite(y).all())
    torch.testing.assert_close(y, exp, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="dtype"):
        tssd.ssd_chunk(args[0].double(), *args[1:])
    with pytest.raises(RuntimeError, match="no backward"):
        tssd.ssd_chunk(args[0].clone().requires_grad_(True), *args[1:])
    strided = args[0].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tssd.ssd_chunk(strided, *args[1:])


@pytest.mark.cuda
def test_ssd_chunk_head_slice_is_ragged_and_refuses_large_chunks(cuda_device):
    """At (24, 130, 20, 40, 1, 20) the plan gives slices of 16 and 4 heads
    (a ragged last slice) on a 132-SM card; a chunk whose score tiles do not
    fit a block's shared memory is refused before any launch."""
    if torch.cuda.get_device_properties(cuda_device).multi_processor_count \
            == 132:
        plan = tssd.launch_plan(24, 130, 20, 1, 20)
        assert (plan.heads_per_block, plan.slices) == (16, 2)
    args = _ssd_inputs(cuda_device, 1, 512, 8, 64, 1, 128, 0)
    _build.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        tssd.ssd_chunk(*args)
    assert _build.LAUNCHES["ssd_chunk"] == 0


@pytest.mark.cuda
def test_serving_launches_ssd_chunk_per_prefill(cuda_device, monkeypatch):
    """A smoke-size ServeEngine on the card: every prefill shot launches K5
    once per Mamba layer and decoding launches it never; the tokens equal
    the plain route's (K5's plain version patched in)."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import model_init
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("mamba2-2.7b").smoke()
    params = model_init(cfg, _gen(cuda_device, 0), cuda_device)
    params["embed/tok"] *= 0.1
    g = np.random.default_rng(0)
    prompts = [tuple(int(t) for t in g.integers(0, cfg.vocab, n))
               for n in (16, 16, 37, 5)]
    got = {}
    for use_kernel in (True, False):
        if not use_kernel:
            monkeypatch.setattr(tssd, "ssd_chunk", tssd.ssd_chunk_plain)
        eng = ServeEngine(cfg, params, slots=4, seq_budget=64,
                          buckets=(16, 32))
        _build.reset_launches()
        eng.insert_batch([Request(id=i, tokens=p, max_new_tokens=6)
                          for i, p in enumerate(prompts[:2])])
        for i, p in enumerate(prompts[2:], start=2):
            eng.insert(Request(id=i, tokens=p, max_new_tokens=6))
        shots = dict(_build.LAUNCHES)["ssd_chunk"]
        while eng.n_active:
            eng.step(decode_chunk=4)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["ssd_chunk"] == shots
        assert shots == (cfg.n_layers * 3 if use_kernel else 0)
        got[use_kernel] = {r.id: r.tokens for r in eng.pop_completed()}
    assert got[True] == got[False]
