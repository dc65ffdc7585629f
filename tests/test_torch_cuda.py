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
from repro_torch.launch import platform

ATOL_ERA = {torch.float32: 1e-6, torch.bfloat16: 5e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    platform.apply("fp32")          # TF32 off: float32 runs in float32
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
                                         (4, 7, 20_000, torch.float32),
                                         (100, 1000, 46, torch.float32),
                                         (10, 256, 32768, torch.float32),
                                         (2, 1024, 32_064, torch.bfloat16),
                                         (2, 1024, 51_865, torch.bfloat16),
                                         (2, 1024, 202_048, torch.bfloat16)])
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
@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("N", [1, 13, 100])
@pytest.mark.parametrize("C", [2, 10, 46, 151, 32768])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_era_kernels_ragged_tiles(cuda_device, K, N, C, dtype):
    """Tail tiles of fewer rows than the plan's R, one client, and 16-, 8-,
    4- and 2-byte loads ((3, 13, 151) bf16 is not 4-byte aligned)."""
    p = _probs(cuda_device, (K, N, C), K * N + C, dtype)
    w = torch.rand((K,), generator=_gen(cuda_device, N), device=cuda_device)
    w = w / w.sum()
    pairs = ((tes.era_sharpen(p, 0.1), tes.era_sharpen_plain(p, 0.1)),
             (tes.weighted_era_sharpen(p, w, 0.1),
              tes.weighted_era_sharpen_plain(p, w, 0.1)),
             (tes.weighted_era_sharpen(p, w, sharpen=False),
              tes.weighted_era_sharpen_plain(p, w, sharpen=False)))
    torch.cuda.synchronize()
    for out, exp in pairs:
        assert out.shape == (N, C)
        torch.testing.assert_close(out, exp, atol=ATOL_ERA[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,zeros", [((4, 9, 12), (0, 3)),
                                         ((100, 1000, 10),
                                          (0, 5, 6, 7, 50, 99))])
@pytest.mark.parametrize("sharpen", [True, False])
def test_zero_weight_client_changes_no_bit(cuda_device, shape, zeros,
                                           sharpen):
    p = _probs(cuda_device, shape, 3)
    garbage = p.clone()
    for i, z in enumerate(zeros):
        garbage[z] = 1e30 if i % 2 == 0 else -1e30
    w = torch.rand((shape[0],), generator=_gen(cuda_device, 4),
                   device=cuda_device)
    w[list(zeros)] = 0.0
    w = w / w.sum()
    a = tes.weighted_era_sharpen(p, w, 0.1, sharpen)
    b = tes.weighted_era_sharpen(garbage, w, 0.1, sharpen)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_era_kernels_repeat_bitwise(cuda_device):
    p = _probs(cuda_device, (100, 1000, 10), 8)
    w = _weights(cuda_device, 100, 9)
    for call in (lambda: tes.era_sharpen(p, 0.1),
                 lambda: tes.weighted_era_sharpen(p, w, 0.1),
                 lambda: tes.weighted_era_sharpen(p, w, sharpen=False)):
        a, b = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_era_wrappers_refuse_without_launching(cuda_device):
    p = _probs(cuda_device, (4, 8, 10), 10)
    w = _weights(cuda_device, 4, 11)
    _build.reset_launches()
    for call, match in ((lambda: tes.era_sharpen(p.half(), 0.1), "dtype"),
                        (lambda: tes.weighted_era_sharpen(p, w[:3]), "weights"),
                        (lambda: tes.weighted_era_sharpen(p, w.double()),
                         "weights"),
                        (lambda: tes.weighted_era_sharpen(
                            p.transpose(1, 2), w), "contiguous")):
        with pytest.raises(ValueError, match=match):
            call()
    assert _build.LAUNCHES["era_sharpen"] == 0
    assert _build.LAUNCHES["weighted_era_sharpen"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("C", [tes.SMEM_BYTES // 4 + 1, 151_936])
@pytest.mark.parametrize("K,N", [(1, 1), (3, 13), (2, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_era_wide_route_matches_plain(cuda_device, K, N, C, dtype):
    """Rows wider than a block's shared memory take the wide route (one
    block a row, two passes): K1, K2 and the weighted mean against their
    plain versions, peaked rows included, a zero-weight client of +-1e30
    rows changing no bit and two launches giving the same bits."""
    p = _probs(cuda_device, (K, N, C), K + N + C, dtype, scale=8.0)
    assert tes.launch_plan(K, N, C, dtype).wide
    w = _weights(cuda_device, K, K) if K > 1 else torch.ones(
        (1,), device=cuda_device)
    atol = ATOL_ERA[dtype]
    calls = ((lambda q: tes.era_sharpen(q, 0.1),
              lambda q: tes.era_sharpen_plain(q, 0.1)),
             (lambda q: tes.weighted_era_sharpen(q, w, 0.1),
              lambda q: tes.weighted_era_sharpen_plain(q, w, 0.1)),
             (lambda q: tes.weighted_era_sharpen(q, w, sharpen=False),
              lambda q: tes.weighted_era_sharpen_plain(q, w, sharpen=False)))
    for kern, plain in calls:
        a, b = kern(p), kern(p)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        torch.testing.assert_close(a, plain(p), atol=atol, rtol=0)
    if K > 1:                                   # client 0 has weight 0
        garbage = p.clone()
        garbage[0] = 1e30
        for kern, _ in calls[1:]:
            assert torch.equal(kern(p), kern(garbage))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,C,dtype", [(100, 1000, 10, torch.float32),
                                         (3, 13, 151, torch.bfloat16),
                                         (10, 256, 32768, torch.float32)])
def test_era_kernel_refuses_a_misaligned_plan(cuda_device, K, N, C, dtype):
    """The C entry checks the plan it is given: 16-byte loads on a pointer
    one element off are refused before launch, not run."""
    buf = _probs(cuda_device, (K * N * C + 1,), 12, dtype)
    p = buf[1:].view(K, N, C)
    out = torch.empty((N, C), device=cuda_device)
    plan = tes.launch_plan(K, N, C, dtype)          # assumes an aligned pointer
    lib = tes._lib()
    err = lib.era_sharpen(_build.ptr(p), _build.ptr(out), K, N, C,
                          tes._DTYPE_CODE[dtype], 1.0 / K, 10.0,
                          *plan.args(), _build.stream_of(out))
    assert err != 0 if plan.vec > 1 else err == 0
    torch.testing.assert_close(tes.era_sharpen(p, 0.1),        # the wrapper's
                               tes.era_sharpen_plain(p, 0.1),  # own plan
                               atol=ATOL_ERA[dtype], rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,dtype", [(100, 10, torch.float32),
                                       (37, 1000, torch.float32),
                                       (64, 4096, torch.bfloat16),
                                       (1024, 32_064, torch.bfloat16),
                                       (1024, 51_865, torch.bfloat16),
                                       (1024, 202_048, torch.bfloat16)])
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


F32, BF16 = torch.float32, torch.bfloat16
ATOL_K3 = {F32: 1e-4, BF16: 2e-2}


def _zt(device, N, V, seed, dtype, off=0):
    """Logits and teacher probabilities (N, V), as views ``off`` rows into
    buffers of N + off rows (z and t then share their pointers' phase)."""
    g = _gen(device, seed)
    z = (torch.randn((N + off, V), generator=g, device=device) * 4).to(dtype)
    t = _probs(device, (N + off, V), seed + 1, dtype, scale=1.0)
    return z[off:], t[off:]


def _error_vs_float64(out, z, t):
    """The largest error in (loss, logZ) against float64 values of z, t."""
    zd, td = z.double(), t.double()
    m = zd.amax(dim=-1, keepdim=True)
    lz = (m + torch.log(torch.exp(zd - m).sum(dim=-1, keepdim=True)))[:, 0]
    exact = (td.sum(dim=-1) * lz - (td * zd).sum(dim=-1), lz)
    return max(float((o.double() - e).abs().max()) for o, e in zip(out, exact))


def _k3_matches_plain(z, t):
    """K3 against its plain version at atol 1e-4 f32, 2e-2 bf16, rtol 1e-3,
    and its error against float64 at most twice the plain version's: that
    catches an element left out of a row (a head, a tail, a vector), which
    the tolerance alone passes (tests/test_torch_distill_plan.py)."""
    loss, logz = tdl.distill_loss_fwd(z, t)
    ploss, plogz = tdl.distill_loss_fwd_plain(z, t)
    torch.cuda.synchronize()
    atol = ATOL_K3[z.dtype]
    torch.testing.assert_close(loss, ploss, atol=atol, rtol=1e-3)
    torch.testing.assert_close(logz, plogz, atol=atol, rtol=1e-3)
    assert _error_vs_float64((loss, logz), z, t) <= 2 * _error_vs_float64(
        (ploss, plogz), z, t)


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,dtype,off", [
    (333, 50_001, F32, 0),      # V odd: only every 4th row starts on 16 bytes
    (64, 50_001, F32, 3),       # and a view three rows in
    (37, 4097, F32, 1),
    (16, 151_937, BF16, 0),     # V = 8k + 1 in bf16
    (40, 1025, BF16, 5),
    (1, 151_936, BF16, 0),      # one row
    (100, 10, F32, 0),          # short rows, 4 lanes each
    (100, 64, F32, 1),
    (5, 65, F32, 1),            # the first long rows
    (9, 1, F32, 1)])
def test_distill_fwd_ragged_and_misaligned_rows(cuda_device, N, V, dtype, off):
    """K3 where rows start off a 16-byte boundary (a scalar head, a vector
    body, a scalar tail), against its plain version and float64."""
    _k3_matches_plain(*_zt(cuda_device, N, V, N + V, dtype, off))


@pytest.mark.cuda
@pytest.mark.parametrize("N,V,dtype", [(333, 50_001, F32),
                                       (64, 151_936, BF16), (100, 10, F32)])
def test_distill_fwd_repeats_bitwise(cuda_device, N, V, dtype):
    z, t = _zt(cuda_device, N, V, 3, dtype)
    a, b = tdl.distill_loss_fwd(z, t), tdl.distill_loss_fwd(z, t)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_distill_fwd_refuses_a_misaligned_plan(cuda_device):
    """The C entry checks the plan it is given: 16-byte loads on pointers 4
    bytes apart are refused before launch; the wrapper's own plan (4-byte
    loads) is right."""
    z, _ = _zt(cuda_device, 64, 4097, 4, F32)
    t = _probs(cuda_device, (64 * 4097 + 1,), 5, scale=1.0)[1:].view(64, 4097)
    plan = tdl.launch_plan(64, 4097)                   # 16-byte loads
    assert plan.vec == 4 and tdl.pointer_align(z, t) == 4
    loss = torch.full((64,), 7.0, device=cuda_device)
    logz = torch.full((64,), 7.0, device=cuda_device)
    before = dict(_build.LAUNCHES)
    lib = tdl._lib()
    err = lib.distill_loss_fwd(_build.ptr(z), _build.ptr(t), _build.ptr(loss),
                               _build.ptr(logz), 64, 4097, 0, *plan.args(),
                               _build.stream_of(z))
    torch.cuda.synchronize()
    assert err != 0
    assert bool((loss == 7.0).all()) and bool((logz == 7.0).all())
    assert dict(_build.LAUNCHES) == before
    _k3_matches_plain(z, t)


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


@pytest.mark.cuda
def test_weighted_mean_on_misaligned_edge_shards(cuda_device):
    """K2's weighted mean on the row-offset views of a two-level round:
    K=7, N=13, C=10 in 3 edges puts shards at 3 and 5 clients in, 8 bytes
    off a 16-byte boundary; they take narrower loads, not a refusal."""
    from repro_torch.core.hierarchy import edge_shards
    p = _probs(cuda_device, (7, 13, 10), 21)
    w = _weights(cuda_device, 7, 22)
    aligns = []
    for start, end in edge_shards(7, 3):
        shard, ws = p[start:end], w[start:end].contiguous()
        ptr = shard.data_ptr()
        aligns.append(ptr & -ptr)
        torch.testing.assert_close(
            tes.weighted_era_sharpen(shard, ws, sharpen=False),
            tes.weighted_era_sharpen_plain(shard, ws, sharpen=False),
            atol=ATOL_ERA[torch.float32], rtol=0)
    assert min(aligns) < 16


def _image_task(device, K, seed):
    from repro_torch.data.pipeline import FederatedImageTask, build_image_task
    t = build_image_task(seed, K, 40 * K, 160, 80, device="cpu")
    return FederatedImageTask(t.x_clients.to(device), t.y_clients.to(device),
                              t.open_x.to(device), t.x_test.to(device),
                              t.y_test.to(device), t.n_classes)


def _narrow_cnn(device):
    import functools
    from repro_torch.models.smallnets import init_mnist_cnn
    return functools.partial(init_mnist_cnn, image_hw=16, widths=(8, 16),
                             fc=32, device=device)


@pytest.mark.cuda
def test_sparse_round_against_masked_on_the_card(cuda_device):
    """K=8, 4 participants, ``active_budget=4`` against the dense masked
    round from the same state and draws: absent clients' leaves and the
    aggregation weights bitwise, the rest within 2e-4 + 1e-3 |x| (the
    m-lane convolutions may run other cuDNN algorithms); K2 once a round."""
    from repro_torch.core import prng
    from repro_torch.core.algorithms import DSFLAlgorithm, RoundDraws
    from repro_torch.core.engine import FedEngine
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.models.smallnets import apply_mnist_cnn
    K = 8
    task = _image_task(cuda_device, K, 0)
    hp = DSFLConfig(rounds=1, local_epochs=1, distill_epochs=1,
                    batch_size=20, open_batch=80)
    ids = torch.arange(K, device=cuda_device)
    draws = [RoundDraws(
        o_idx=prng.permutation(1, 0, "open", 0, 160, cuda_device)[:80],
        update_perms=prng.epoch_perms(1, 0, "update", ids, 1, 40, 20),
        distill_perms=prng.epoch_perms(1, 0, "distill", ids, 1, 80, 20),
        server_perms=prng.epoch_perms(1, 0, "server", ids[:1], 1, 80,
                                      20)[0])]
    mask = torch.tensor([[0, 1, 1, 0, 1, 0, 0, 1]], dtype=torch.float32,
                        device=cuda_device)
    algo = DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=True,
                         device=cuda_device)
    start = FedEngine(algo).init(_narrow_cnn(cuda_device), task)
    out = []
    for budget in (None, 4):
        eng = FedEngine(algo)
        _build.reset_launches()
        state = eng.run(start, task, draws=draws, ctx_plan={"mask": mask},
                        active_budget=budget)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["weighted_era_sharpen"] == 1
        out.append((state, eng.last_metrics))
    (dense, dm), (sparse, sm) = out
    assert torch.equal(dm["agg_weights"], sm["agg_weights"])
    absent = (mask[0] == 0).nonzero()[:, 0]
    for f in ("params", "model_state"):
        for k, v in getattr(dense.clients, f).items():
            got = getattr(sparse.clients, f)[k]
            before = getattr(start.clients, f)[k]
            assert torch.equal(got[absent], before[absent])
            torch.testing.assert_close(got, v, atol=2e-4, rtol=1e-3)


@pytest.mark.cuda
def test_fedavg_round_card_against_cpu(cuda_device):
    """One FedAvg round (K=4, the narrow CNN) from the same weights and
    draws on the card and on the CPU: the server's leaves within 2e-4 +
    1e-3 |x|.  FedAvg launches no kernel."""
    from repro_torch.core import prng
    from repro_torch.core.algorithms import (FedAvgAlgorithm, FedAvgConfig,
                                             RoundDraws)
    from repro_torch.core.engine import FedEngine
    from repro_torch.models.smallnets import apply_mnist_cnn
    K = 4
    hp = FedAvgConfig(rounds=1, local_epochs=1, batch_size=20)
    w0, s0 = _narrow_cnn("cpu")(torch.Generator().manual_seed(2))
    draws = [RoundDraws(update_perms=prng.epoch_perms(
        3, 0, "update", torch.arange(K), 1, 40, 20))]
    got = {}
    _build.reset_launches()
    for device in (cuda_device, torch.device("cpu")):
        algo = FedAvgAlgorithm(apply_mnist_cnn, hp, device=device)
        mv = lambda t: {k: v.to(device) for k, v in t.items()}
        state = FedEngine(algo).run(algo.init_from(mv(w0), mv(s0)),
                                    _image_task(device, K, 4), draws=draws)
        got[device.type] = state.server
    assert not any(_build.LAUNCHES.values())
    for f in ("params", "model_state"):
        for k, v in getattr(got["cpu"], f).items():
            torch.testing.assert_close(getattr(got["cuda"], f)[k].cpu(), v,
                                       atol=2e-4, rtol=1e-3)


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
    (1, 1, 12, 40, 3, 20),          # Q = 1 with G > 1
    (8, 128, 80, 64, 1, 128)])      # the LLM round's prediction, seq 128
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


# ------------------------------------------------ keyed draws, chunks, ckpts --
@pytest.mark.cuda
@pytest.mark.parametrize("rnd", [0, 1, 2 ** 33 + 5])
def test_keyed_draws_card_equal_cpu(cuda_device, rnd):
    """Keys, epoch permutations and the open batch of a round are the same
    bits on the card and on the CPU, for dense and scattered ids."""
    from repro_torch.core import prng
    from repro_torch.core.engine import open_batch
    for ids in (torch.arange(100), torch.tensor([7, 999_999, 3, 2 ** 40])):
        assert torch.equal(prng.keys(5, rnd, "update", ids, (3, 50)),
                           prng.keys(5, rnd, "update", ids.to(cuda_device),
                                     (3, 50)).cpu())
        assert torch.equal(
            prng.epoch_perms(5, rnd, "distill", ids, 2, 1000, 100),
            prng.epoch_perms(5, rnd, "distill", ids.to(cuda_device), 2, 1000,
                             100).cpu())
    assert torch.equal(open_batch(5, rnd, 10_000, 1_000, "cpu"),
                       open_batch(5, rnd, 10_000, 1_000, cuda_device).cpu())


def _sim_setup(device):
    from repro_torch.core.algorithms import DSFLAlgorithm
    from repro_torch.core.engine import FedEngine
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.models.smallnets import apply_mnist_cnn
    K = 8
    hp = DSFLConfig(rounds=4, local_epochs=1, distill_epochs=1,
                    batch_size=20, open_batch=80)
    algo = DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=True, device=device)
    task = _image_task(device, K, 5)
    mask = torch.tensor([[1, 0, 1, 0, 1, 1, 0, 0], [0, 1, 1, 0, 0, 0, 1, 1],
                         [1, 1, 0, 0, 1, 0, 0, 1], [0, 0, 1, 1, 0, 1, 1, 0]],
                        dtype=torch.float32)
    return algo, task, FedEngine(algo).init(_narrow_cnn(device), task), mask


@pytest.mark.cuda
def test_chunked_run_against_loop_on_the_card(cuda_device):
    """4 sparse rounds (budget 4) through ``chunk_rounds=2``, the pipelined
    schedule and the loop: the same metrics and leaves within 2e-4 +
    1e-3 |x| (the card is not bitwise reproducible); K2 once a round in
    each run."""
    from repro_torch.checkpoint import named_leaves
    from repro_torch.core.engine import FedEngine
    algo, task, start, mask = _sim_setup(cuda_device)
    out = {}
    for name, kw in (("loop", {}), ("chunked", dict(chunk_rounds=2)),
                     ("pipelined", dict(chunk_rounds=4, overlap=True))):
        eng = FedEngine(algo)
        _build.reset_launches()
        state = eng.run(start, task, ctx_plan={"mask": mask},
                        active_budget=4, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["weighted_era_sharpen"] == 4
        assert _build.LAUNCHES["era_sharpen"] == 0
        out[name] = (dict(named_leaves(state)), eng.history)
    ref, hist = out["loop"]
    for name in ("chunked", "pipelined"):
        leaves, h = out[name]
        assert [r["round"] for r in h] == [r["round"] for r in hist]
        for a, b in zip(h, hist):
            for k, v in b.items():
                assert abs(a[k] - v) <= 2e-4 + 1e-3 * abs(v), (name, k)
        for k, v in ref.items():
            torch.testing.assert_close(leaves[k], v, atol=2e-4, rtol=1e-3)


@pytest.mark.cuda
def test_save_load_round_trip_on_the_card(cuda_device, tmp_path):
    """2 rounds, ``save_state``, a fresh engine's ``load_state`` (leaves on
    the card, bitwise the saved ones), 2 more rounds: within 2e-4 + 1e-3 |x|
    of 4 uninterrupted rounds, with the same round count and history
    rounds."""
    from repro_torch.checkpoint import named_leaves
    from repro_torch.core.engine import FedEngine
    algo, task, start, mask = _sim_setup(cuda_device)
    full = FedEngine(algo).run(start, task, ctx_plan={"mask": mask},
                               active_budget=4)
    eng = FedEngine(algo)
    half = eng.run(start, task, rounds=2, ctx_plan={"mask": mask[:2]},
                   active_budget=4)
    path = str(tmp_path / "ckpt")
    eng.save_state(path, half)
    eng2 = FedEngine(algo)
    loaded = eng2.load_state(path, start)
    assert eng2.rounds_done == 2 and eng2.history == eng.history
    for (k, a), (_, b) in zip(named_leaves(loaded), named_leaves(half)):
        assert a.device.type == "cuda" and torch.equal(a, b), k
    resumed = eng2.run(loaded, task, rounds=2, ctx_plan={"mask": mask[2:]},
                       active_budget=4)
    assert eng2.rounds_done == 4
    for (k, a), (_, b) in zip(named_leaves(resumed), named_leaves(full)):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 2, 1000, 10_000])
def test_lane_sum_is_sequential_on_the_card(cuda_device, cols):
    """`lanes.lane_sum` on the card equals an fp32 loop over the lanes,
    bitwise, for one, two and many columns, with values spread over 12
    decades (so any other order shows); exact-zero lanes anywhere change
    no bit.  The cohort plane's equality with the dense rounds on the card
    rests on this order, which is how torch runs cumsum (a thread a column
    down dim 0; the lone column copied to two) and not a documented
    contract: a torch that changes it fails here."""
    from repro_torch.lanes import lane_sum
    rng = np.random.default_rng(cols)
    x = torch.from_numpy((rng.standard_normal((37, cols))
                          * np.logspace(-6, 6, 37)[:, None]).astype(np.float32)
                         ).to(cuda_device)
    acc = x[0].clone()
    for k in range(1, x.shape[0]):
        acc = acc + x[k]
    assert torch.equal(lane_sum(x), acc)
    rows = [torch.zeros_like(x[0])] * 2 + list(x[:5]) + [torch.zeros_like(
        x[0])] + list(x[5:]) + [torch.zeros_like(x[0])]
    assert torch.equal(lane_sum(torch.stack(rows)), acc)


@pytest.mark.cuda
@pytest.mark.parametrize("N,V", [(333, 10), (256, 50280)])
def test_distill_loss_f32_logits_bf16_teacher(cuda_device, N, V):
    """The LLM round distills f32 logits (the smoke configs, the route
    check) on the bf16 teacher: ``ops.distill_loss`` widens the teacher to
    f32 (exact) for K3/K4, and the loss and gradient equal autograd of the
    plain loss on the same f32 values; the gradient stays f32."""
    g = _gen(cuda_device, N + V)
    z = torch.randn((N, V), generator=g, device=cuda_device) * 4
    t = _probs(cuda_device, (N, V), N, torch.bfloat16, scale=1.0)
    zk = z.clone().requires_grad_(True)
    _build.reset_launches()
    lk = ops.distill_loss(zk, t)
    lk.backward()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["distill_loss_fwd"] == 1
    assert _build.LAUNCHES["distill_loss_bwd"] == 1
    zp = z.clone().requires_grad_(True)
    lp = tdl.distill_loss_fwd_plain(zp, t.float())[0].mean()
    lp.backward()
    torch.cuda.synchronize()
    assert zk.grad.dtype == F32
    torch.testing.assert_close(lk, lp, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(zk.grad, zp.grad, atol=1e-6 / N * 4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-2.7b", "qwen1.5-4b",
                                  "phi-3-vision-4.2b", "whisper-small",
                                  "llama4-scout-17b-a16e",
                                  "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_llm_smoke_round_card_against_cpu(cuda_device, arch):
    """One LLM DS-FL round and one FedAvg round on ``arch``'s smoke config
    (K=2, batch 2, seq 32) from the same weights and data on the card (K1,
    K3, K4, and K5 in each Mamba sub-layer of the prediction) and on the
    CPU (their plain versions): leaves and loss within 2e-4 + 1e-3 |x|.
    The rounds are chip_smoke.py's ``llm_smoke_rounds``, which its LLM
    phases compare the same way."""
    import importlib.util
    from pathlib import Path

    from repro_torch.configs import get_config
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = get_config(arch).smoke()
    k5 = 2 * cfg.n_blocks * sum(m == "mamba" for m, _ in cfg.pattern)
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        _build.reset_launches()
        out[device.type] = smoke.llm_smoke_rounds(device, arch)
        if device.type == "cuda":
            torch.cuda.synchronize()
            for name, n in (("era_sharpen", 1), ("distill_loss_fwd", 2),
                            ("distill_loss_bwd", 2),
                            ("ssd_chunk", k5)):
                assert _build.LAUNCHES[name] == n, name
    for (cuda_p, cuda_l), (cpu_p, cpu_l) in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(cuda_l.cpu(), cpu_l, atol=2e-4, rtol=1e-3)
        for k, v in cpu_p.items():
            torch.testing.assert_close(cuda_p[k].cpu(), v, atol=2e-4,
                                       rtol=1e-3)


@pytest.mark.cuda
def test_whisper_prefill_then_decode_on_the_card(cuda_device):
    """whisper-small's smoke config in float32 on the card: a prefill of 8
    tokens, then 8 decode steps at a (B,) position, each step's logits
    within 1e-4 of the largest teacher-forced logit (the prefill fills the
    decoder's rings: ROADMAP, deviation 16), and equal to the CPU's within
    2e-4 + 1e-3 |x|."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.models.api import (model_decode_step, model_init,
                                        model_prefill)
    cfg = get_config("whisper-small").smoke()
    params = model_init(cfg, torch.Generator().manual_seed(3), "cpu")
    g = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=g)
    frames = torch.randn((2, cfg.n_audio_frames, cfg.d_model), generator=g)
    steps = {}
    for device in (cuda_device, torch.device("cpu")):
        p = {k: v.to(device) for k, v in params.items()}
        t, f = toks.to(device), frames.to(device)
        with torch.no_grad():
            full = encdec.decoder_logits(cfg, p, t,
                                         encdec.encode(cfg, p, f))
            lg, cache = model_prefill(cfg, p, {"tokens": t[:, :8],
                                               "frames": f}, 16)
            seen = [lg]
            for i in range(8, 16):
                lg, cache = model_decode_step(
                    cfg, p, cache, t[:, i], torch.full((2,), i,
                                                       device=device))
                seen.append(lg)
        want = full[:, 7:]
        got = torch.stack(seen, 1)
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())
        steps[device.type] = got.cpu()
    torch.testing.assert_close(steps["cuda"], steps["cpu"], atol=2e-4,
                               rtol=1e-3)


# ----------------------------------------------------------- paper models --
def _paper_inputs(name, n, seed):
    g = torch.Generator().manual_seed(seed)
    if name == "fmnist_cnn":
        return torch.randn((n, 28, 28, 1), generator=g)
    if name == "reuters_dnn":
        return (torch.rand((n, 10_000), generator=g) < 0.004).float()
    return torch.randint(0, 20_000, (n, 80), generator=g)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fmnist_cnn", "reuters_dnn", "imdb_lstm"])
def test_paper_model_card_against_cpu(cuda_device, name):
    """Each new paper model at full width, the same weights and inputs on
    the card and on the CPU: logits in train and eval mode, the new
    BatchNorm state, and the training loss's gradients, within 1e-4 +
    1e-3 |x|."""
    from torch.func import grad_and_value

    from repro_torch.core.losses import xent_int_labels
    from repro_torch.models.smallnets import make_smallnet
    net = make_smallnet(name, device="cpu")
    p, s = net.init(torch.Generator().manual_seed(0))
    s = {k: v + 0.1 for k, v in s.items()}
    x = _paper_inputs(name, 8, 1)
    y = torch.arange(8) % net.n_classes
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        mv = lambda t: {k: v.to(device) for k, v in t.items()}
        xd, yd, sd = x.to(device), y.to(device), mv(s)

        def loss(p_):
            logits, ns = net.apply(p_, sd, xd, True)
            return xent_int_labels(logits, yd), ns

        grads, (value, ns) = grad_and_value(loss, has_aux=True)(mv(p))
        with torch.no_grad():
            evals = net.apply(mv(p), sd, xd, False)[0]
        out[device.type] = {"loss": value.reshape(1), "eval": evals,
                            **{f"grad/{k}": v for k, v in grads.items()},
                            **{f"state/{k}": v for k, v in ns.items()}}
    for k, v in out["cpu"].items():
        torch.testing.assert_close(out["cuda"][k].cpu(), v, atol=1e-4,
                                   rtol=1e-3, msg=k)


# ------------------------------------------------------ MoE and hot swap --
@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e",
                                  "llama4-maverick-400b-a17b",
                                  "jamba-1.5-large-398b"])
def test_moe_ffn_card_against_cpu(cuda_device, arch):
    """One MoE FFN of each MoE arch's smoke config in f32 on 64 tokens (4
    groups of 16, tokens dropped at the configs' capacity factor): the
    routes equal where the router's top-two gap exceeds 1e-5, and the
    output and load-balance loss within 1e-5 + 1e-4 |x| where they do."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch).smoke()
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        pd = {k: v.to(device) for k, v in p.items()}
        xg = x.to(device).reshape(4, 16, -1)
        out[device.type] = [t.cpu() for t in moe.route(pd, cfg, xg)] + [
            t.cpu() for t in moe.moe_ffn(pd, cfg, x.to(device))]
    (g, i, r, k, a, y, aux), cpu = out["cuda"], out["cpu"]
    assert not bool(cpu[3].all())                   # some choices dropped
    gates = torch.softmax(x.reshape(4, 16, -1) @ p["router"], dim=-1)
    top2 = torch.topk(gates, 2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) < 1e-5
    same = ((i == cpu[1]) & (r == cpu[2]) & (k == cpu[3])).all(dim=-1)
    assert bool((same | near).all())
    if bool(same.all()):
        torch.testing.assert_close(y, cpu[5], atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(aux, cpu[6], atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_hot_swap_on_the_card(cuda_device):
    """A live FedEngine LLM DS-FL run of the smoke qwen1.5-4b on the card
    hot-swaps a server on the card after each round; the served weights
    are bitwise ``eval_params`` of the final state, in the server's own
    storage, and K1, K3 and K4 ran on the trainer's path."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FedEngine
    from repro_torch.core.llm_algorithms import LLMDSFLAlgorithm
    from repro_torch.core.llm_dsfl import LLMDsflHP
    from repro_torch.data.pipeline import build_lm_task
    from repro_torch.models.api import model_init
    from repro_torch.serve import Request, ServeEngine, attach
    cfg = get_config("qwen1.5-4b").smoke()
    task = build_lm_task(0, 2, 4, 32, cfg.vocab, device="cuda")
    algo = LLMDSFLAlgorithm(cfg, LLMDsflHP(lr=5e-3, rounds=2, open_batch=4,
                                           use_kernel=True), device="cuda")
    fed = FedEngine(algo)
    state = fed.init(lambda g: model_init(cfg, g, "cuda"), task)
    srv = ServeEngine(cfg, model_init(cfg, _gen("cuda", 1), "cuda"),
                      slots=2, seq_budget=48, buckets=(8, 16))
    prompt = tuple(range(1, 13))
    srv.insert(Request(id=0, tokens=prompt, max_new_tokens=4))
    while srv.n_active:
        srv.step()
    assert srv.pop_completed()[0].weights_version == 0
    sync = attach(fed, srv, algo)
    _build.reset_launches()
    state = fed.run(state, task, rounds=2)
    torch.cuda.synchronize()
    for name in ("era_sharpen", "distill_loss_fwd", "distill_loss_bwd"):
        assert _build.LAUNCHES[name] > 0, name
    assert [r for r, _ in sync.swap_log] == [1, 2]
    srv.insert(Request(id=1, tokens=prompt, max_new_tokens=4))
    while srv.n_active:
        srv.step()
    assert srv.pop_completed()[0].weights_version == 2
    want, _ = algo.eval_params(state)
    for k, v in want.items():
        assert torch.equal(srv.params[k], v), k
        assert srv.params[k].data_ptr() != \
            state.clients.params[k].data_ptr(), k
