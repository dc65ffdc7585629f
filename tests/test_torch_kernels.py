"""K1-K4: the plain versions (what the wrappers compute on CPU tensors)
against the reference's Pallas kernels in interpret mode and its jnp
oracles, at the reference's own tolerances.  The CUDA kernels themselves
are held to the plain versions on the card, in test_torch_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.distill_loss import (distill_loss_bwd_pallas,
                                        distill_loss_fwd_pallas)
from repro.kernels.era_sharpen import (era_sharpen_pallas,
                                       weighted_era_sharpen_pallas)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import distill_loss as tdl
from repro_torch.kernels import era_sharpen as tes
from repro_torch.kernels import ref as tref

from test_torch_convert import one_intra_op_thread  # noqa: F401



def _probs(seed, shape, scale=1.0):
    r = np.random.default_rng(seed)
    x = r.standard_normal(shape).astype(np.float32) * scale
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _weights(seed, K):
    w = np.random.default_rng(seed).uniform(size=K).astype(np.float32)
    w[0] = 0.0
    return (w / w.sum()).astype(np.float32)


def _pair(p_np, dtype):
    """The same values as a jax and a torch array of one dtype."""
    if dtype == "bf16":
        j = jnp.asarray(p_np).astype(jnp.bfloat16)
        t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
            torch.bfloat16)
        return j, t
    return jnp.asarray(p_np), torch.from_numpy(p_np.copy())


ATOL_ERA = {"f32": 1e-6, "bf16": 5e-3}


# ------------------------------------------------------------------ K1 / K2 --
@pytest.mark.parametrize("K,N,C", [(2, 1, 10), (3, 13, 151), (10, 100, 46)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T", [0.1, 1.0])
def test_era_sharpen_plain_vs_pallas(K, N, C, dtype, T):
    pj, pt = _pair(_probs(K * N + C, (K, N, C)), dtype)
    out = tes.era_sharpen(pt, T)              # CPU tensor -> plain version
    assert out.dtype == torch.float32 and out.shape == (N, C)
    atol = ATOL_ERA[dtype]
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(era_sharpen_pallas(pj, T,
                                                             interpret=True)),
                               atol=atol)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref.era_sharpen_ref(pj, T)),
                               atol=atol)
    np.testing.assert_allclose(ops.era_sharpen(pt, T).numpy(),
                               tref.era_sharpen_ref(pt, T).numpy(), atol=atol)


@pytest.mark.parametrize("K,N,C", [(2, 1, 10), (3, 13, 151), (10, 100, 46)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("sharpen", [True, False])
def test_weighted_era_sharpen_plain_vs_pallas(K, N, C, dtype, sharpen):
    pj, pt = _pair(_probs(K + N * C, (K, N, C), 2.0), dtype)
    w = _weights(K, K)
    out = tes.weighted_era_sharpen(pt, torch.from_numpy(w), 0.1, sharpen)
    exp = weighted_era_sharpen_pallas(pj, jnp.asarray(w), 0.1,
                                      sharpen=sharpen, interpret=True)
    atol = ATOL_ERA[dtype]
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), atol=atol)
    np.testing.assert_allclose(
        out.numpy(),
        np.asarray(jref.weighted_era_sharpen_ref(pj, jnp.asarray(w), 0.1,
                                                 sharpen)), atol=atol)
    via_ops = (ops.weighted_era_sharpen(pt, torch.from_numpy(w), 0.1)
               if sharpen else ops.weighted_mean(pt, torch.from_numpy(w)))
    np.testing.assert_allclose(
        via_ops.numpy(),
        tref.weighted_era_sharpen_ref(pt, torch.from_numpy(w), 0.1,
                                      sharpen).numpy(), atol=atol)


def test_weighted_era_zero_weight_client_changes_no_bit():
    p = _probs(3, (4, 9, 12))
    w = torch.tensor([0.0, 0.5, 0.5, 0.0])
    garbage = p.copy()
    garbage[0], garbage[3] = 1e30, -1e30
    a = tes.weighted_era_sharpen(torch.from_numpy(p), w, 0.1)
    b = tes.weighted_era_sharpen(torch.from_numpy(garbage), w, 0.1)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


# ------------------------------------------------------------------ K3 / K4 --
def _logits_targets(seed, N, V):
    r = np.random.default_rng(seed)
    z = (r.standard_normal((N, V)) * 4).astype(np.float32)
    return z, _probs(seed + 1, (N, V))


@pytest.mark.parametrize("N,V,bn,bv", [(32, 128, 8, 32), (64, 1024, 16, 256),
                                       (8, 64, 8, 16)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_distill_loss_fwd_plain_vs_pallas(N, V, bn, bv, dtype):
    z, t = _logits_targets(N + V, N, V)
    zj, zt = _pair(z, dtype)
    tj, tt = _pair(t, dtype)
    loss, logz = tdl.distill_loss_fwd(zt, tt)
    ploss, plogz = distill_loss_fwd_pallas(zj, tj, block_n=bn, block_v=bv,
                                           interpret=True)
    atol = 2e-2 if dtype == "bf16" else 1e-4
    np.testing.assert_allclose(loss.numpy(), np.asarray(ploss), atol=atol,
                               rtol=1e-3)
    np.testing.assert_allclose(logz.numpy(), np.asarray(plogz), atol=atol,
                               rtol=1e-3)
    np.testing.assert_allclose(loss.numpy(),
                               np.asarray(jref.distill_loss_ref(zj, tj)),
                               atol=atol, rtol=1e-3)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_distill_loss_bwd_plain_vs_pallas(dtype):
    N, V = 32, 256
    z, t = _logits_targets(7, N, V)
    zj, zt = _pair(z, dtype)
    tj, tt = _pair(t, dtype)
    _, logz = tdl.distill_loss_fwd(zt, tt)
    tmass = tt.float().sum(-1)
    g = torch.tensor([0.75 / N])
    dz = tdl.distill_loss_bwd(zt, tt, logz, tmass, g)
    assert dz.dtype == zt.dtype
    exp = distill_loss_bwd_pallas(zj, tj, jnp.asarray(logz.numpy()),
                                  jnp.asarray(tmass.numpy()),
                                  jnp.asarray(g.numpy()), interpret=True)
    atol = 2e-2 if dtype == "bf16" else 1e-6
    np.testing.assert_allclose(dz.float().numpy(),
                               np.asarray(exp.astype(jnp.float32)), atol=atol)


def test_distill_loss_grad_matches_refs():
    """ops.distill_loss_2d's backward (K4's plain version on CPU) against
    the reference's gradient oracle (atol 1e-6) and against autograd of the
    plain loss (1e-5)."""
    z, t = _logits_targets(11, 64, 256)
    z = z * 0.75
    zt = torch.from_numpy(z).requires_grad_(True)
    tt = torch.from_numpy(t)
    ops.distill_loss_2d.apply(zt, tt).backward()
    ge = jref.distill_loss_grad_ref(jnp.asarray(z), jnp.asarray(t),
                                    jnp.float32(1.0))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(ge), atol=1e-6)
    za = torch.from_numpy(z).requires_grad_(True)
    tref.distill_loss_ref(za, tt).mean().backward()
    np.testing.assert_allclose(zt.grad.numpy(), za.grad.numpy(), atol=1e-5)
    gj = jax.grad(lambda z_: jnp.mean(jref.distill_loss_ref(z_, jnp.asarray(t))))(
        jnp.asarray(z))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gj), atol=1e-5)


def test_distill_loss_with_mask_is_the_masked_xent():
    from repro.core.losses import softmax_xent
    z, t = _logits_targets(5, 12, 10)
    m = (np.arange(12) % 3 != 0).astype(np.float32)
    out = ops.distill_loss(torch.from_numpy(z), torch.from_numpy(t),
                           torch.from_numpy(m))
    np.testing.assert_allclose(
        float(out), float(softmax_xent(jnp.asarray(z), jnp.asarray(t),
                                       jnp.asarray(m))), atol=1e-6)


def test_plain_wrappers_count_no_launch():
    _build.reset_launches()
    p = torch.from_numpy(_probs(1, (2, 3, 4)))
    tes.era_sharpen(p, 0.1)
    tes.weighted_era_sharpen(p, torch.tensor([0.5, 0.5]), 0.1)
    z, t = _logits_targets(2, 4, 8)
    ops.distill_loss(torch.from_numpy(z).requires_grad_(True),
                     torch.from_numpy(t)).backward()
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


def test_wrappers_refuse_other_devices():
    meta = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tes.era_sharpen(meta, 0.1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tdl.distill_loss_fwd(torch.empty((2, 3), device="meta"),
                             torch.empty((2, 3), device="meta"))
