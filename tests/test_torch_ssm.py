"""K5 and the Mamba2 mixer: the port's plain versions (what a CPU tensor
gets) against the reference's Pallas kernel in interpret mode, its jnp
oracle and its ``models/ssm.py``, on the same inputs made by numpy from a
seed and the same weights carried across by ``convert``.

Tolerances: K5 atol = rtol = 1e-4, the reference's own
(tests/test_kernels.py); the mixer, its SSD core and its decode step in
float32 atol 1e-5 (rtol 1e-5 for the values of order 10 and more that the
SSD core's sums reach)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro.models import ssm as jssm
from repro.models.base import ModelConfig as JConfig
from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ssd_chunk as tssd
from repro_torch.models import ssm as tssm
from repro_torch.models.base import ModelConfig

from test_torch_convert import to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

K5_TOL = dict(atol=1e-4, rtol=1e-4)
MIX_TOL = dict(atol=1e-5, rtol=1e-5)
# the reference's SSD-in-mamba config (tests/test_kernels.py), with G = 2
CFG = dict(name="s", arch_type="ssm", n_layers=2, d_model=64, n_heads=0,
           n_kv_heads=0, d_ff=0, vocab=97, ssm_state=16, ssm_head_dim=16,
           ssm_chunk=8, ssm_groups=2, dtype="float32")


@functools.partial(jax.jit, static_argnums=(5, 6))
def _j_ssd_chunked(x, dt, a, B, C, chunk, use_kernel):
    return jssm.ssd_chunked(x, dt, a, B, C, chunk,
                            kernel_fn=jops.ssd_chunk if use_kernel else None,
                            return_state=True)


@functools.partial(jax.jit, static_argnums=(1,))
def _j_forward(p, cfg, x):
    return jssm.mamba_forward(p, cfg, x, return_cache=True)


_j_decode = jax.jit(jssm.mamba_decode_step, static_argnums=(1,))


def _ssd_inputs(seed, M, Q, H, P, G, N):
    """x, dt, dA, B, C as numpy float32: dt = softplus(normal), dA = -0.3 dt
    (as tests/test_kernels.py draws them)."""
    r = np.random.default_rng(seed)
    x = r.standard_normal((M, Q, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((M, Q, H)))).astype(np.float32)
    dA = (-dt * 0.3).astype(np.float32)
    B = r.standard_normal((M, Q, G, N)).astype(np.float32)
    C = r.standard_normal((M, Q, G, N)).astype(np.float32)
    return x, dt, dA, B, C


@pytest.mark.parametrize("M,Q,H,P,G,N", [
    (2, 8, 4, 8, 1, 8), (3, 16, 4, 8, 2, 8), (1, 32, 8, 16, 4, 16),
    (4, 16, 6, 8, 3, 4), (3, 1, 4, 8, 2, 8)])
def test_ssd_chunk_plain_vs_pallas_and_ref(M, Q, H, P, G, N):
    arrs = _ssd_inputs(M * Q + H, M, Q, H, P, G, N)
    want = np.asarray(ssd_chunk_pallas(*map(jnp.asarray, arrs),
                                       interpret=True))
    oracle = np.asarray(jref.ssd_chunk_ref(*map(jnp.asarray, arrs)))
    ts = [torch.from_numpy(a) for a in arrs]
    plain = tssd.ssd_chunk_plain(*ts)
    wrapped = tssd.ssd_chunk(*ts)               # CPU tensor -> plain version
    assert plain.dtype == torch.float32 and plain.shape == (M, Q, H, P)
    torch.testing.assert_close(wrapped, plain, atol=0, rtol=0)
    np.testing.assert_allclose(plain.numpy(), want, **K5_TOL)
    np.testing.assert_allclose(plain.numpy(), oracle, **K5_TOL)
    # ops.ssd_chunk: the (B, nc, Q, ...) form the SSD core calls
    x, dt, dA, B, C = ts
    r5 = lambda a: a.reshape((1, M) + tuple(a.shape[1:]))
    y5 = tops.ssd_chunk(r5(x), r5(dt), r5(dA), r5(B), r5(C), H // G)
    np.testing.assert_allclose(y5.reshape(M, Q, H, P).numpy(), want, **K5_TOL)


def test_ssd_chunk_refuses_what_it_cannot_take():
    x, dt, dA, B, C = (torch.from_numpy(a) for a in
                       _ssd_inputs(0, 2, 8, 4, 8, 1, 8))
    with pytest.raises(ValueError, match="hpg"):
        tops.ssd_chunk(x[None], dt[None], dA[None], B[None], C[None], 3)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tssd.ssd_chunk(x.to("meta"), dt, dA, B, C)


def _ssd_chunked_inputs(seed, Bsz, S, H, P, G, N):
    r = np.random.default_rng(seed)
    x = r.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(r.standard_normal((Bsz, S, H)))).astype(np.float32)
    a_log = (r.standard_normal((H,)) * 0.5).astype(np.float32)
    B = r.standard_normal((Bsz, S, G, N)).astype(np.float32)
    C = r.standard_normal((Bsz, S, G, N)).astype(np.float32)
    return x, dt, a_log, B, C


@pytest.mark.parametrize("S,chunk", [(32, 8), (21, 8), (5, 16)])
def test_ssd_chunked_matches_reference(S, chunk):
    """Against the reference with and without its kernel route (``kernel_fn``
    = the Pallas kernel in interpret mode), S a multiple of the chunk or
    not, y and the final state."""
    arrs = _ssd_chunked_inputs(S, 2, S, 4, 8, 2, 8)
    ts = [torch.from_numpy(a) for a in arrs]
    y, st = tssm.ssd_chunked(*ts, chunk, return_state=True)
    assert y.shape == (2, S, 4, 8) and st.shape == (2, 4, 8, 8)
    for use_kernel in (False, True):
        jy, jst = _j_ssd_chunked(*map(jnp.asarray, arrs), chunk, use_kernel)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MIX_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), **MIX_TOL)
    y_only = tssm.ssd_chunked(*ts, chunk)
    torch.testing.assert_close(y_only, y, atol=0, rtol=0)


@pytest.fixture(scope="module")
def mixer():
    jcfg = JConfig(**CFG)
    p = jax.jit(jssm.init_mamba, static_argnums=(1,))(
        jax.random.PRNGKey(1), jcfg)
    # a non-trivial A and skip, so a_log and d_skip are exercised
    p["a_log"] = jnp.linspace(-0.5, 0.5, jcfg.ssm_heads)
    p["d_skip"] = jnp.linspace(0.5, 1.5, jcfg.ssm_heads)
    return jcfg, ModelConfig(**CFG), p, to_port(p)


@pytest.mark.parametrize("S", [16, 13, 2])
def test_mamba_forward_and_cache_match_reference(mixer, S):
    jcfg, cfg, jp, tp = mixer
    x = np.random.default_rng(S).standard_normal((2, S, 64)).astype(
        np.float32)
    jy, jc = _j_forward(jp, jcfg, jnp.asarray(x))
    y, c = tssm.mamba_forward(tp, cfg, torch.from_numpy(x),
                              return_cache=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MIX_TOL)
    for k in ("state", "conv_x", "conv_b", "conv_c"):
        want = np.asarray(jc[k])
        if k != "state" and want.shape[1] < cfg.ssm_conv - 1:
            # the reference keeps only S rows of the window; the port
            # left-pads it with the zeros the causal conv read
            pad = cfg.ssm_conv - 1 - want.shape[1]
            want = np.pad(want, ((0, 0), (pad, 0), (0, 0)))
        np.testing.assert_allclose(c[k].numpy(), want, err_msg=k, **MIX_TOL)
    y_only = tssm.mamba_forward(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y_only.numpy(), np.asarray(jy), **MIX_TOL)


def test_mamba_decode_step_matches_reference(mixer):
    """Three decode steps from a prefill cache, token by token."""
    jcfg, cfg, jp, tp = mixer
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 12, 64)).astype(np.float32)
    _, jc = _j_forward(jp, jcfg, jnp.asarray(x))
    _, tc = tssm.mamba_forward(tp, cfg, torch.from_numpy(x),
                               return_cache=True)
    for step in range(3):
        x1 = r.standard_normal((2, 1, 64)).astype(np.float32)
        jy, jc = _j_decode(jp, jcfg, jnp.asarray(x1), jc)
        ty, tc = tssm.mamba_decode_step(tp, cfg, torch.from_numpy(x1), tc)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **MIX_TOL)
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       err_msg=f"step {step} {k}", **MIX_TOL)
    # and the empty cache of the reference
    zero = jssm.init_ssm_cache(jcfg, 3)
    tz = tssm.init_ssm_cache(cfg, 3, "cpu")
    for k in zero:
        assert tuple(tz[k].shape) == zero[k].shape and not tz[k].any()
