"""The port's MoE FFN (`repro_torch.models.moe`) against the reference's
`repro.models.moe` on the same inputs and parameters: ``capacity`` on a
grid, ``init_moe``'s layout, ``moe_ffn``'s output and load-balance loss in
f32 within 1e-5 (SwiGLU and GELU, top-1 and top-2, capacity factors that
drop tokens and that do not), the dispatch (which (token, choice) is kept
and its rank in the expert's buffer) exactly, ties (all-zero rows: uniform
gates go to the lowest expert indices), gradients against ``jax.grad``
and a bf16 case.

The reference's dispatch and combine tensors are read off its own run: its
module's ``jnp`` is swapped for a namespace that records the operands of
the dispatch and combine einsums."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models.base import ModelConfig as JConfig
from repro_torch.models import moe as TM
from repro_torch.models.base import ModelConfig

from test_torch_convert import to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

D, F_, E, GS = 16, 24, 4, 8
TOL = 1e-5


def _cfgs(**kw):
    base = dict(name="moe-test", arch_type="moe", n_layers=1, d_model=D,
                n_heads=2, n_kv_heads=2, d_ff=F_, vocab=64, n_experts=E,
                top_k=1, moe_group_size=GS, dtype="float32")
    base.update(kw)
    return JConfig(**base), ModelConfig(**base)


def _params(jcfg, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, to_port(jp)


def _x(shape, seed=1, zero_rows=()):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    for b, s in zero_rows:
        x[b, s] = 0.0
    return x


def _reference(jp, jcfg, x, monkeypatch):
    """The reference's (out, aux) and its (G, gs, E, C) dispatch and
    combine tensors, recorded from its einsums."""
    seen = {}

    def einsum(spec, *ops):
        seen[spec] = ops
        return jnp.einsum(spec, *ops)

    rec = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                   if not k.startswith("__")})
    rec.einsum = einsum
    monkeypatch.setattr(JM, "jnp", rec)
    out, aux = JM.moe_ffn(jp, jcfg, jnp.asarray(x))
    monkeypatch.undo()
    return (np.asarray(out), float(aux),
            np.asarray(seen["gsec,gsd->egcd"][0]),
            np.asarray(seen["gsec,egcd->gsd"][0]))


def _port_dispatch(tp, cfg, x):
    B, S, _ = x.shape
    gs = min(cfg.moe_group_size, B * S)
    xg = torch.from_numpy(x).reshape(-1, gs, x.shape[-1])
    top_g, top_i, rank, keep, _ = TM.route(tp, cfg, xg)
    disp, comb = TM.dispatch(top_g, top_i, rank, keep, cfg.n_experts,
                             TM.capacity(cfg, gs), xg.dtype)
    return disp.numpy(), comb.numpy(), top_i, keep


def test_capacity_matches_reference():
    for e in (1, 4, 16, 128):
        for k in (1, 2):
            for cf in (0.5, 1.0, 1.25, 2.0, 4.0):
                jcfg, cfg = _cfgs(n_experts=e, top_k=min(k, e),
                                  capacity_factor=cf)
                for gs in (1, 2, 7, 8, 16, 256, 1000):
                    assert TM.capacity(cfg, gs) == JM.capacity(jcfg, gs)


def test_init_moe_layout_matches_reference():
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(dtype=dtype)
        jp, _ = _params(jcfg)
        want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jp.items()}
        own = TM.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for k, v in own.items()}
        assert got == want
        stacked = TM.init_moe(torch.Generator().manual_seed(0), cfg, "cpu",
                              n_blocks=3)
        assert {k: tuple(v.shape) for k, v in stacked.items()} == {
            k: (3,) + s for k, (s, _) in want.items()}
        # every expert matrix drawn on its own: no two blocks or experts alike
        w = stacked["w_up"].reshape(3 * E, -1)
        assert len({tuple(r[:4].tolist()) for r in w}) == 3 * E
        assert abs(float(own["router"].std()) - D ** -0.5) < 0.1


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cf", [1.0, 4.0])
def test_moe_ffn_matches_reference(act, top_k, cf, monkeypatch):
    """Three groups of 8 tokens; at capacity factor 1.0 some (token,
    choice) pairs overflow their expert and drop, at 4.0 none do."""
    jcfg, cfg = _cfgs(act=act, top_k=top_k, capacity_factor=cf)
    jp, tp = _params(jcfg, seed=top_k)
    x = _x((3, 8, D))
    out, aux, disp, comb = _reference(jp, jcfg, x, monkeypatch)
    got, got_aux = TM.moe_ffn(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), out, atol=TOL, rtol=TOL)
    assert abs(float(got_aux) - aux) <= TOL
    tdisp, tcomb, _, keep = _port_dispatch(tp, cfg, x)
    np.testing.assert_array_equal(tdisp, disp)     # kept set and ranks
    np.testing.assert_allclose(tcomb, comb, atol=1e-7)
    dropped = int((~keep).sum())
    assert (dropped > 0) == (cf == 1.0)


def test_ties_go_to_the_lowest_experts(monkeypatch):
    """All-zero rows give zero logits and uniform gates: top-2 picks
    experts 0 and 1, in that order, and the ranks follow."""
    jcfg, cfg = _cfgs(top_k=2, capacity_factor=1.0)
    jp, tp = _params(jcfg, seed=3)
    zeros = [(0, s) for s in range(8)] + [(1, 2), (1, 5)]
    x = _x((2, 8, D), seed=4, zero_rows=zeros)
    out, aux, disp, _ = _reference(jp, jcfg, x, monkeypatch)
    tdisp, _, top_i, _ = _port_dispatch(tp, cfg, x)
    assert top_i[0].tolist() == [[0, 1]] * 8
    assert top_i[1, 2].tolist() == top_i[1, 5].tolist() == [0, 1]
    np.testing.assert_array_equal(tdisp, disp)
    got, got_aux = TM.moe_ffn(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), out, atol=TOL, rtol=TOL)
    assert abs(float(got_aux) - aux) <= TOL


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_gradients_match_jax_grad(act):
    """d/dparams and d/dx of sum(out * w) + aux, top-2 at capacity factor
    1.0 (drops included), against ``jax.grad``."""
    jcfg, cfg = _cfgs(act=act, top_k=2, capacity_factor=1.0)
    jp, tp = _params(jcfg, seed=5)
    x = _x((2, 8, D), seed=6)
    w = _x((2, 8, D), seed=7)

    def jloss(p, x_):
        out, aux = JM.moe_ffn(p, jcfg, x_)
        return jnp.sum(out * w) + aux

    gp, gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = TM.moe_ffn(leaves, cfg, xt)
    (torch.sum(out * torch.from_numpy(w)) + aux).backward()
    for k, v in leaves.items():
        # GELU leaves w_gate unused: no gradient here, zeros there
        g = torch.zeros_like(v) if v.grad is None else v.grad
        np.testing.assert_allclose(g.numpy(), np.asarray(gp[k]),
                                   atol=TOL, rtol=TOL, err_msg=k)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=TOL,
                               rtol=TOL)


def test_bf16_matches_reference(monkeypatch):
    """bf16 experts and activations (the router stays f32): the same routes
    exactly, the output within 2 bf16 steps (2^-7) of its largest
    magnitude; the two packages round the einsums' bf16 outputs at
    different points."""
    jcfg, cfg = _cfgs(top_k=2, capacity_factor=1.0, dtype="bfloat16")
    jp, tp = _params(jcfg, seed=8)
    x = _x((2, 8, D), seed=9)
    xb = jnp.asarray(x, jnp.bfloat16)
    out, aux, disp, _ = _reference(jp, jcfg, xb, monkeypatch)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16)
    got, got_aux = TM.moe_ffn(tp, cfg, xt)
    assert got.dtype == torch.bfloat16
    out = np.asarray(out, np.float32)
    err = np.abs(got.float().numpy() - out).max()
    assert err <= 2 ** -7 * np.abs(out).max(), err
    assert abs(float(got_aux) - aux) <= TOL
    gs = GS
    top_g, top_i, rank, keep, _ = TM.route(tp, cfg, xt.reshape(-1, gs, D))
    tdisp, _ = TM.dispatch(top_g, top_i, rank, keep, E, TM.capacity(cfg, gs),
                           torch.bfloat16)
    np.testing.assert_array_equal(tdisp.float().numpy(),
                                  np.asarray(disp, np.float32))


def test_groups_must_divide_the_tokens():
    _, cfg = _cfgs()
    tp = TM.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="groups of 8"):
        TM.moe_ffn(tp, cfg, torch.zeros((1, 12, D)))
    assert dataclasses.replace(cfg, moe_group_size=12).moe_group_size == 12
