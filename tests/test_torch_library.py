"""K1-K5 as ``torch.library`` ops (`repro_torch.kernels.library`) on the
CPU: ``torch.library.opcheck`` of each op (its schema, its CPU and fake
implementations against each other, its autograd registration, and
AOT dispatch); each op's output bitwise its plain version and within the
existing tolerances of the Pallas kernel in interpret mode and of
`repro.kernels.ref`; the FLOP and byte formulas against hand counts (K1's
bytes at (2, 1024, 151936) bf16 giving PERF.md's 0.37154 ms bound); a
fake trace counting each op once where the card launches it once."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.library import opcheck
from torch.utils.flop_counter import FlopCounterMode

from repro.kernels import ref as jref
from repro.kernels.distill_loss import (distill_loss_bwd_pallas,
                                        distill_loss_fwd_pallas)
from repro.kernels.era_sharpen import (era_sharpen_pallas,
                                       weighted_era_sharpen_pallas)
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro_torch.kernels import _build, library, ops
from repro_torch.kernels import distill_loss as tdl
from repro_torch.kernels import era_sharpen as tes
from repro_torch.kernels import ssd_chunk as tssd
from repro_torch.launch import costs, specs
from repro_torch.launch.roofline import bound_ms

from test_torch_convert import one_intra_op_thread  # noqa: F401

OPS = torch.ops.repro_torch
F32, BF16 = torch.float32, torch.bfloat16


def _probs(seed, shape):
    r = np.random.default_rng(seed)
    x = r.random(shape).astype(np.float32) + 1e-3
    return x / x.sum(-1, keepdims=True)


def _inputs(name, seed=0, grad=False):
    """Small CPU inputs of op ``name`` (numpy-seeded), the first
    requiring a gradient with ``grad``."""
    r = np.random.default_rng(seed)
    if name in ("era_sharpen", "weighted_era_sharpen"):
        p = torch.from_numpy(_probs(seed, (3, 5, 7)))
        w = torch.from_numpy(np.array([0.5, 0.2, 0.3], np.float32))
        args = (p, 0.1) if name == "era_sharpen" else (p, w, 0.1, True)
    elif name in ("distill_loss_fwd", "distill_loss_bwd"):
        z = torch.from_numpy((r.standard_normal((6, 9)) * 3).astype(
            np.float32))
        t = torch.from_numpy(_probs(seed + 1, (6, 9)))
        if name == "distill_loss_fwd":
            args = (z, t)
        else:
            _, logz = tdl.distill_loss_fwd_plain(z, t)
            args = (z, t, logz, t.sum(-1), torch.tensor([0.25]))
    else:
        M, Q, H, P, G, N = 2, 8, 4, 3, 2, 5
        dt = np.log1p(np.exp(r.standard_normal((M, Q, H)))).astype(
            np.float32)
        args = tuple(torch.from_numpy(a) for a in (
            r.standard_normal((M, Q, H, P)).astype(np.float32), dt,
            (-0.3 * dt).astype(np.float32),
            r.standard_normal((M, Q, G, N)).astype(np.float32),
            r.standard_normal((M, Q, G, N)).astype(np.float32)))
    if grad:
        args = (args[0].clone().requires_grad_(),) + args[1:]
    return args


PLAIN = {"era_sharpen": tes.era_sharpen_plain,
         "weighted_era_sharpen": tes.weighted_era_sharpen_plain,
         "distill_loss_fwd": tdl.distill_loss_fwd_plain,
         "distill_loss_bwd": tdl.distill_loss_bwd_plain,
         "ssd_chunk": tssd.ssd_chunk_plain}


@pytest.mark.parametrize("name", library.OPS)
def test_opcheck(name):
    """Schema, fake against CPU implementation, AOT dispatch; then the
    autograd registration with an input that requires a gradient."""
    op = getattr(OPS, name)
    opcheck(op, _inputs(name))
    opcheck(op, _inputs(name, grad=True),
            test_utils="test_autograd_registration")


@pytest.mark.parametrize("name", library.OPS)
def test_op_is_bitwise_its_plain_version(name):
    args = _inputs(name, seed=3)
    _build.reset_launches()
    got, want = getattr(OPS, name)(*args), PLAIN[name](*args)
    for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert g.is_contiguous()
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_ops_match_pallas_interpret_and_ref():
    """Each op on the CPU against the reference's Pallas kernel in
    interpret mode and `repro.kernels.ref` (fp32 atol 1e-6; K5 1e-4, its
    existing tolerance)."""
    p, T = _inputs("era_sharpen", 5)
    pj = jnp.asarray(p.numpy())
    out = OPS.era_sharpen(p, T).numpy()
    np.testing.assert_allclose(out, np.asarray(era_sharpen_pallas(
        pj, T, interpret=True)), atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jref.era_sharpen_ref(pj, T)),
                               atol=1e-6)
    p, w, T, _ = _inputs("weighted_era_sharpen", 6)
    out = OPS.weighted_era_sharpen(p, w, T, True).numpy()
    wj = jnp.asarray(w.numpy())
    np.testing.assert_allclose(out, np.asarray(weighted_era_sharpen_pallas(
        jnp.asarray(p.numpy()), wj, T, interpret=True)), atol=1e-6)
    np.testing.assert_allclose(out, np.asarray(jref.weighted_era_sharpen_ref(
        jnp.asarray(p.numpy()), wj, T)), atol=1e-6)
    z, t = _inputs("distill_loss_fwd", 7)
    zj, tj = jnp.asarray(z.numpy()), jnp.asarray(t.numpy())
    loss, logz = OPS.distill_loss_fwd(z, t)
    ploss, plogz = distill_loss_fwd_pallas(zj, tj, block_n=8, block_v=16,
                                           interpret=True)
    np.testing.assert_allclose(loss.numpy(), np.asarray(ploss), atol=1e-5)
    np.testing.assert_allclose(logz.numpy(), np.asarray(plogz), atol=1e-6)
    np.testing.assert_allclose(loss.numpy(), np.asarray(
        jref.distill_loss_ref(zj, tj)), atol=1e-5)
    tmass, g = t.sum(-1), torch.tensor([0.5 / 6])
    dz = OPS.distill_loss_bwd(z, t, logz, tmass, g)
    np.testing.assert_allclose(dz.numpy(), np.asarray(distill_loss_bwd_pallas(
        zj, tj, jnp.asarray(logz.numpy()), jnp.asarray(tmass.numpy()),
        jnp.asarray(g.numpy()), interpret=True)), atol=1e-6)
    np.testing.assert_allclose(dz.numpy(), np.asarray(
        jref.distill_loss_grad_ref(zj, tj, jnp.float32(0.5))), atol=1e-6)
    xs = _inputs("ssd_chunk", 8)
    js = [jnp.asarray(a.numpy()) for a in xs]
    y = OPS.ssd_chunk(*xs).numpy()
    np.testing.assert_allclose(y, np.asarray(ssd_chunk_pallas(
        *js, interpret=True)), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(y, np.asarray(jref.ssd_chunk_ref(*js)),
                               atol=1e-4, rtol=1e-4)


def test_distill_loss_gradient_flows_to_z_through_k4():
    """`ops.distill_loss_2d` over the two ops: z's gradient is K4's (the
    reference's oracle within 1e-6), t gets none."""
    z, t = _inputs("distill_loss_fwd", 9)
    z = z.clone().requires_grad_()
    t = t.clone().requires_grad_()
    ops.distill_loss_2d.apply(z, t).backward()
    assert t.grad is None
    want = jref.distill_loss_grad_ref(jnp.asarray(z.detach().numpy()),
                                      jnp.asarray(t.detach().numpy()),
                                      jnp.float32(1.0))
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want), atol=1e-6)


def test_flop_formulas_against_hand_counts():
    """K5 counts its two products (2 Q^2 N a chunk and group, 2 Q^2 P a
    chunk and head); K1-K4 count 0."""
    for name in library.OPS:
        args = _inputs(name)
        with FlopCounterMode(display=False) as fc:
            getattr(OPS, name)(*args)
        if name == "ssd_chunk":
            M, Q, H, P, G, N = 2, 8, 4, 3, 2, 5
            want = 2 * Q * Q * N * M * G + 2 * Q * Q * P * M * H
        else:
            want = 0
        assert fc.get_total_flops() == want, name
        assert library.op_bytes(name, *args) == sum(
            a.nbytes for a in args if isinstance(a, torch.Tensor)) + sum(
            o.nbytes for o in (lambda r: r if isinstance(r, tuple) else (r,))(
                getattr(OPS, name)(*args))), name


def test_byte_formulas_give_perf_md_bounds():
    """Inputs read plus outputs written, as PERF.md's "bound (bytes)"
    column: K1 at (2, 1024, 151936) bf16 reads and writes 622,329,856 B
    each, 0.37154 ms at 3.35 TB/s; K3 at (2048, 151936) bf16 0.37155 ms;
    K4 there 0.55732 ms; K5 at the prefill's shape 0.10423 ms."""
    m = specs.fake_mode()
    with m:
        p = torch.empty((2, 1024, 151936), dtype=BF16)
        z = torch.empty((2048, 151936), dtype=BF16)
        rows = torch.empty((2048,))
        x = torch.empty((32, 256, 80, 64))
        d = torch.empty((32, 256, 80))
        b = torch.empty((32, 256, 1, 128))
    k1 = library.op_bytes("era_sharpen", p, 0.1)
    assert k1 == 2 * 622_329_856
    assert round(bound_ms(k1, 0)[0], 5) == 0.37154
    k3 = library.op_bytes("distill_loss_fwd", z, z)
    assert round(bound_ms(k3, 0)[0], 5) == 0.37155
    k4 = library.op_bytes("distill_loss_bwd", z, z, rows, rows,
                          torch.empty((1,)))
    assert round(bound_ms(k4, 0)[0], 5) == 0.55732
    k5 = library.op_bytes("ssd_chunk", x, d, d, b, b)
    assert round(bound_ms(k5, 0)[0], 5) == 0.10423


def test_fake_trace_counts_each_op_once():
    """Under fake tensors each op runs its fake implementation: the
    outputs' shapes and dtypes, one count in `launch.costs` per call,
    nothing launched; the checks that need no pointer still refuse."""
    m = specs.fake_mode()
    with m:
        p = torch.empty((2, 4, 6), dtype=BF16)
        w = torch.empty((2,))
        z = torch.empty((5, 11))
        x = torch.empty((2, 8, 4, 3))
        d = torch.empty((2, 8, 4))
        b = torch.empty((2, 8, 1, 5))
    _build.reset_launches()
    with m, costs.count(p, w, z, x, d, b) as rec:
        assert tuple(tes.era_sharpen(p, 0.1).shape) == (4, 6)
        assert tes.weighted_era_sharpen(p, w, 0.1).dtype == F32
        loss, logz = tdl.distill_loss_fwd(z, z)
        dz = tdl.distill_loss_bwd(z, z, logz, loss, torch.empty((1,)))
        assert dz.shape == z.shape and dz.dtype == z.dtype
        assert tssd.ssd_chunk(x, d, d, b, b).shape == x.shape
        with pytest.raises(ValueError, match="contiguous"):
            tes.era_sharpen(p.transpose(1, 2), 0.1)
    assert rec.ops == dict.fromkeys(library.OPS, 1)
    assert all(v == 0 for v in _build.LAUNCHES.values())
