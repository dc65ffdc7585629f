"""The port's dense-family layers against the reference, on the same inputs
drawn with numpy: RoPE, the three MLP activations, ``head_mask`` with
``pad_heads``, the ``pad_vocab`` logit mask, chunked ``flash_attention``
(sequence lengths, chunk sizes, grouped-query heads, causal and window
masks, ``q_offset``) and the ring-buffer decode step, whose rows each carry
their own position (held to one reference call per row) and which writes
the cache in place.

Tolerance: float32 throughout; atol 2e-5 on RoPE (cos and sin of angles up
to 96 rad, where one float32 step of the angle is 7.6e-6), atol 1e-5 with
rtol 1e-5 on attention, MLP and logit outputs of order 1-100."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL

from test_torch_convert import to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
ROPE_TOL = dict(atol=2e-5, rtol=0.0)
# a small dense config: d 64, 4 heads of 16 over 2 KV heads (G = 2), bias
JCFG = jget_config("qwen1.5-4b").smoke().replace(
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96)
CFG = get_config("qwen1.5-4b").smoke().replace(
    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96)


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ RoPE ----
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_matches_reference(theta):
    jcfg, cfg = JCFG.replace(rope_theta=theta), CFG.replace(rope_theta=theta)
    x = _normal(0, 2, 96, 4, 16)
    pos = np.arange(96)
    jc, js = JL.rope_freqs(jcfg, jnp.asarray(pos))
    tc, ts = TL.rope_freqs(cfg, _t(pos))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **ROPE_TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **ROPE_TOL)
    want = JL.apply_rope(jnp.asarray(x), jc, js)
    np.testing.assert_allclose(TL.apply_rope(_t(x), tc, ts).numpy(),
                               np.asarray(want), **ROPE_TOL)
    # per-row positions: cos/sin of (B, S, hd/2)
    rows = np.stack([np.arange(96), np.arange(96) + 40])
    jc, js = JL.rope_freqs(jcfg, jnp.asarray(rows))
    tc, ts = TL.rope_freqs(cfg, _t(rows))
    want = JL.apply_rope(jnp.asarray(x), jc, js)
    np.testing.assert_allclose(TL.apply_rope(_t(x), tc, ts).numpy(),
                               np.asarray(want), **ROPE_TOL)
    # the rotation is computed in f32 and cast back
    assert TL.apply_rope(_t(x).bfloat16(), tc, ts).dtype == torch.bfloat16


# ------------------------------------------------------------------ MLPs ----
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(act):
    jp = JL.init_mlp(jax.random.PRNGKey(1), JCFG.replace(act=act))
    if act == "gelu":                       # non-zero biases
        jp["b_up"] = jnp.asarray(_normal(5, JCFG.d_ff, scale=0.1))
        jp["b_down"] = jnp.asarray(_normal(6, JCFG.d_model, scale=0.1))
    tp = to_port(jp)
    own = TL.init_mlp(torch.Generator().manual_seed(0),
                      CFG.replace(act=act), "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in tp.items()}
    x = _normal(2, 3, 5, JCFG.d_model)
    want = JL.mlp(jp, JCFG.replace(act=act), jnp.asarray(x))
    got = TL.mlp(tp, CFG.replace(act=act), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------ head and vocab pads --
def test_head_mask_and_padded_heads_match_reference():
    """pad_heads=6 on an MHA config of 4 heads: the padded heads' outputs
    are zero, and the whole self-attention equals the reference's."""
    jcfg = JCFG.replace(n_kv_heads=4, pad_heads=6)
    cfg = CFG.replace(n_kv_heads=4, pad_heads=6)
    jp = JA.init_attn(jax.random.PRNGKey(2), jcfg)
    tp = to_port(jp)
    own = TA.init_attn(torch.Generator().manual_seed(0), cfg, "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        k: tuple(v.shape) for k, v in tp.items()}
    o = _normal(3, 2, 5, 6, 16)
    got = TA.head_mask(cfg, _t(o))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JA.head_mask(jcfg, jnp.asarray(o))))
    assert not got[:, :, 4:].any() and bool(got[:, :, :4].ne(0).all())
    x = _normal(4, 2, 12, 64)
    want = JA.attn_forward(jp, jcfg, jnp.asarray(x), q_chunk=4, kv_chunk=4)
    got = TA.attn_forward(tp, cfg, _t(x), q_chunk=4, kv_chunk=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="MHA"):
        TA.init_attn(torch.Generator(), CFG.replace(pad_heads=6), "cpu")
    # no padding: the mask is the identity
    np.testing.assert_array_equal(TA.head_mask(CFG, _t(o)).numpy(), o)


def test_pad_vocab_mask_matches_reference():
    jcfg, cfg = JCFG.replace(pad_vocab=520), CFG.replace(pad_vocab=520)
    jp = JL.init_embed(jax.random.PRNGKey(3), jcfg)
    tp = to_port(jp)
    x = _normal(5, 2, 3, 64)
    want = np.asarray(JL.unembed(jp, jcfg, jnp.asarray(x)))
    got = TL.unembed(tp, cfg, _t(x)).numpy()
    assert got.shape == (2, 3, 520)
    np.testing.assert_allclose(got, want, **TOL)
    assert (got[..., cfg.vocab:] == -1e30).all()
    assert (got[..., :cfg.vocab] > -1e29).all()


# ------------------------------------------------------ flash attention ----
_j_flash = functools.partial(jax.jit, static_argnames=(
    "causal", "window", "q_chunk", "kv_chunk", "q_offset"))(
        JA.flash_attention)

MODES = {"causal": dict(causal=True, window=None),
         "window": dict(causal=True, window=5),
         "full": dict(causal=False, window=None),
         "offset": dict(causal=True, window=None)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S", [7, 64, 96])
def test_flash_attention_matches_reference(S, G, mode):
    """q (2, Sq, 2G, 16) over k/v (2, S, 2, 16) in f32, at three chunk
    plans each: one chunk, chunks of 16 and 32 (fitted down to divisors of
    S, so 7 runs in chunks of 7), and chunks of 8 and 24.  ``offset``: the
    queries are the last S - S//4 positions (``q_offset`` = S//4)."""
    Kh, hd = 2, 16
    off = S // 4 if mode == "offset" else 0
    q = _normal(10 + S, 2, S - off, Kh * G, hd)
    k = _normal(11 + S, 2, S, Kh, hd)
    v = _normal(12 + S, 2, S, Kh, hd)
    kw = MODES[mode]
    for qc, kc in ((S, S), (16, 32), (8, 24)):
        want = _j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_chunk=qc, kv_chunk=kc, q_offset=off, **kw)
        got = TA.flash_attention(_t(q), _t(k), _t(v), q_chunk=qc,
                                 kv_chunk=kc, q_offset=off, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"chunks {qc}, {kc}", **TOL)


def test_fit_chunk_matches_reference():
    for S in (1, 7, 64, 96, 1030, 2048):
        for c in (1, 5, 16, 1024):
            assert TA._fit_chunk(S, c) == JA._fit_chunk(S, c)


# ----------------------------------------------------------- decode step ----
_j_decode = jax.jit(JA.attn_decode_step, static_argnums=(1,))


@pytest.mark.parametrize("window", [None, 5])
def test_decode_step_per_row_positions_through_ring_wrap(window):
    """Three rows at positions 3, 8 and 21 over a ring of W = 8 slots
    (the last two wrap from the first step), 6 steps: the port's batched
    step with a (3,) position vector equals three reference calls, one per
    row with its scalar position, in outputs and caches; the port writes
    its cache in place."""
    jcfg = JCFG.replace(sliding_window=window)
    cfg = CFG.replace(sliding_window=window)
    jp = JA.init_attn(jax.random.PRNGKey(4), jcfg)
    tp = to_port(jp)
    B, W = 3, 8
    ck = _normal(20, B, W, 2, 16)
    cv = _normal(21, B, W, 2, 16)
    jcache = [{"k": jnp.asarray(ck[b:b + 1]), "v": jnp.asarray(cv[b:b + 1])}
              for b in range(B)]
    tcache = {"k": _t(ck.copy()), "v": _t(cv.copy())}
    kbuf = tcache["k"]
    pos = np.array([3, 8, 21])
    for step in range(6):
        x = _normal(30 + step, B, 1, 64)
        got, tcache = TA.attn_decode_step(tp, cfg, _t(x), tcache,
                                          _t(pos + step))
        assert tcache["k"] is kbuf                      # written in place
        for b in range(B):
            want, jcache[b] = _j_decode(jp, jcfg, jnp.asarray(x[b:b + 1]),
                                        jcache[b], jnp.int32(pos[b] + step))
            np.testing.assert_allclose(got[b:b + 1].numpy(),
                                       np.asarray(want), **TOL)
            for leaf in ("k", "v"):
                np.testing.assert_allclose(
                    tcache[leaf][b:b + 1].numpy(), np.asarray(jcache[b][leaf]),
                    err_msg=f"step {step} row {b} {leaf}", **TOL)


def test_decode_step_scalar_position_broadcasts():
    """One scalar position for every row is the reference's own call."""
    jp = JA.init_attn(jax.random.PRNGKey(5), JCFG)
    tp = to_port(jp)
    ck, cv = _normal(40, 2, 8, 2, 16), _normal(41, 2, 8, 2, 16)
    x = _normal(42, 2, 1, 64)
    want, jc = _j_decode(jp, JCFG, jnp.asarray(x),
                         {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                         jnp.int32(11))
    got, tc = TA.attn_decode_step(tp, CFG, _t(x),
                                  {"k": _t(ck.copy()), "v": _t(cv.copy())}, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), **TOL)
    # only slot 11 % 8 of each row changed
    changed = (tc["v"].numpy() != cv).any(axis=(2, 3))
    assert changed.tolist() == [[j == 3 for j in range(8)]] * 2


@pytest.mark.parametrize("S,W", [(5, 8), (8, 8), (13, 8)])
def test_ring_layout_is_the_reference_prefill_cache(S, W):
    """Slot t % W holds token t of the last W: rolled when S >= W, zero
    padded when S < W (the reference's ``_block_prefill``)."""
    kv = _normal(50, 2, S, 2, 4)
    last = kv[:, -W:]
    want = (np.roll(last, S % W, axis=1) if S >= W else
            np.concatenate([last, np.zeros((2, W - S, 2, 4), np.float32)], 1))
    got = TA.ring_layout(_t(kv), W).numpy()
    np.testing.assert_array_equal(got, want)
    for t in range(max(0, S - W), S):
        np.testing.assert_array_equal(got[:, t % W], kv[:, t])
