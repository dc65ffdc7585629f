"""The port's encoder-decoder (`repro_torch.models.encdec`, whisper-small)
against the reference's `repro.models.encdec`, on whisper-small's smoke
config (2 encoder and 2 decoder layers, d 128, 4 heads of 32, 32 frames,
vocabulary 512, float32) from the reference's own ``init_encdec`` carried
across by ``convert``, with tokens and frame embeddings drawn with numpy:
the sinusoid, the parameter layout, the encoder, each layer's cross keys
and values, the teacher-forced decoder, decoding from an empty cache step
by step (logits and every cache leaf), bfloat16 logits, ``lm_loss`` and
one SGD step, and the full-width parameter count chip_smoke.py asserts.

Prefill then decode equals the teacher-forced decoder in the port.  The
reference's audio ``model_prefill`` returns empty decoder rings, so its
first decode step attends to zeros; the port fills them (ROADMAP,
deviation 16), and the test shows both sides of that.

Tolerance as in tests/test_torch_dense_lm.py: float32 logits atol 1e-4
with rtol 1e-5 (logits of order 100), cache leaves atol 1e-5; bfloat16
atol 2^-6 of the largest magnitude; after an SGD step the leaves at atol
1e-5 and the loss at 1e-5 with rtol 1e-6 (tests/test_torch_dense_train.py).
The sinusoid's angles come from float32 ``pow`` and its values from ``sin``
and ``cos``, which XLA's CPU build and torch's round differently in the
last place: it is held to one float32 step of its largest angle, F * 2^-23
(the reference's own tests run it in float32 too)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget_config
from repro.core import llm_dsfl as J
from repro.models import api as japi
from repro.models import encdec as JE
from repro_torch.configs import get_config
from repro_torch.core import llm_dsfl as T
from repro_torch.models import api as tapi
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TE
from repro_torch.models.base import param_count

from test_torch_convert import flat_ref, to_port
from test_torch_dense_lm import CACHE_TOL, LOGIT_TOL, _cache_close, _close
from test_torch_convert import one_intra_op_thread  # noqa: F401

ARCH = "whisper-small"
B, S = 2, 12


@functools.lru_cache(maxsize=None)
def _weights(dtype="float32"):
    jcfg = jget_config(ARCH).smoke().replace(dtype=dtype)
    cfg = get_config(ARCH).smoke().replace(dtype=dtype)
    jp = jax.jit(lambda k: JE.init_encdec(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, to_port(jp)


def _inputs(seed, cfg, S=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal(
        (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    return toks, frames


def _jbatch(toks, frames):
    return {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}


def _tbatch(toks, frames):
    return {"tokens": torch.from_numpy(toks).long(),
            "frames": torch.from_numpy(frames)}


_j_logits = jax.jit(lambda cfg, p, b: japi.model_logits(cfg, p, b)[0],
                    static_argnums=0)
_j_prefill = jax.jit(lambda cfg, p, b, seq_len: japi.model_prefill(
    cfg, p, b, seq_len), static_argnums=(0, 3))
_j_decode = jax.jit(lambda cfg, p, c, t, pos: japi.model_decode_step(
    cfg, p, c, t, pos), static_argnums=0)


# ------------------------------------------------------------- layout ----
@pytest.mark.parametrize("F,D", [(32, 128), (1500, 768)])
def test_sinusoid_matches_reference(F, D):
    want = np.asarray(JE._sinusoid(F, D))
    got = TE._sinusoid(F, D).numpy()
    assert got.shape == want.shape == (F, D) and got.dtype == np.float32
    # position 0: sines 0 and cosines 1, exactly
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got, want, atol=F * 2.0 ** -23, rtol=0)


def test_config_and_init_layout_match_reference():
    jcfg, cfg, jp, tp = _weights()
    want = dataclasses.asdict(jget_config(ARCH))
    del want["scan_unroll"]                     # an XLA dry-run switch
    assert dataclasses.asdict(get_config(ARCH)) == want
    own = tapi.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    # the reference's names cross as they are, stacked axes leading
    assert tuple(tp["enc/attn/wq"].shape) == (2, 128, 128)
    assert tuple(tp["dec/cross/wk"].shape) == (2, 128, 128)
    assert tuple(tp["pos_dec"].shape) == (cfg.max_seq, 128)
    assert {"enc_norm/scale", "dec/n3/scale", "dec/mlp/b_up",
            "embed/tok"} <= set(own)
    assert param_count(tp) == sum(int(a.size) for a in jax.tree.leaves(jp))


def test_full_width_parameter_count():
    """The count chip_smoke.py asserts on the card: the reference's
    ``init_encdec`` of whisper-small, counted without drawing it, and the
    port's, made under fake tensors."""
    shapes = jax.eval_shape(lambda k: JE.init_encdec(jget_config(ARCH), k),
                            jax.random.PRNGKey(0))
    assert sum(int(a.size) for a in jax.tree.leaves(shapes)) == 263_318_784
    with FakeTensorMode():
        own = tapi.model_init(get_config(ARCH), torch.Generator(), "cpu")
        assert param_count(own) == 263_318_784
        got = {k: tuple(v.shape) for k, v in own.items()}
    assert got == {"/".join(p.key for p in path): tuple(v.shape)
                   for path, v in jax.tree_util.tree_flatten_with_path(
                       shapes)[0]}


# ------------------------------------------------------------- forward ----
def test_encode_cross_kv_and_decoder_match_reference():
    jcfg, cfg, jp, tp = _weights()
    toks, frames = _inputs(0, cfg)
    j_enc = jax.jit(lambda p, f: JE.encode(jcfg, p, f, remat=False))(
        jp, jnp.asarray(frames))
    enc = TE.encode(cfg, tp, torch.from_numpy(frames))
    _close(enc, j_enc, CACHE_TOL, "encoder states")
    for i in range(cfg.n_layers):
        jk, jv = JE.cross_kv(jax.tree.map(lambda a: a[i], jp["dec"])["cross"],
                             jcfg, j_enc)
        tk, tv = TA.cross_kv(TE.sub(TE._block(tp, i, "dec"), "cross"), cfg,
                             enc)
        _close(tk, jk, CACHE_TOL, f"cross k {i}")
        _close(tv, jv, CACHE_TOL, f"cross v {i}")
    want = jax.jit(lambda p, t, e: JE.decoder_logits(jcfg, p, t, e,
                                                     remat=False))(
        jp, jnp.asarray(toks), j_enc)
    _close(TE.decoder_logits(cfg, tp, torch.from_numpy(toks).long(), enc),
           want, LOGIT_TOL, "decoder logits")
    got, aux = tapi.model_logits(cfg, tp, _tbatch(toks, frames))
    _close(got, _j_logits(jcfg, jp, _jbatch(toks, frames)), LOGIT_TOL,
           "model_logits")
    assert float(aux) == 0.0


def test_decode_from_empty_cache_matches_reference():
    """``model_init_cache`` (empty rings, the cross keys and values of the
    frames) and S decode steps one token at a time: logits and every cache
    leaf against the reference's after each step."""
    jcfg, cfg, jp, tp = _weights()
    toks, frames = _inputs(1, cfg)
    jc = japi.model_init_cache(jcfg, jp, B, S, {"frames": jnp.asarray(
        frames)})
    tc = tapi.model_init_cache(cfg, tp, B, S,
                               {"frames": torch.from_numpy(frames)})
    _cache_close(tc, jc, CACHE_TOL, "empty ")
    assert tuple(tc["self/k"].shape) == (2, B, S, 4, 32)
    assert tuple(tc["cross_k"].shape) == (2, B, cfg.n_audio_frames, 4, 32)
    for t in range(S):
        jl, jc = _j_decode(jcfg, jp, jc, jnp.asarray(toks[:, t]),
                           jnp.int32(t))
        tl, tc = tapi.model_decode_step(cfg, tp, tc,
                                        torch.from_numpy(toks[:, t]).long(),
                                        t)
        _close(tl, jl, LOGIT_TOL, f"step {t} logits")
        _cache_close(tc, jc, CACHE_TOL, f"step {t} ")


@pytest.mark.parametrize("S0", [1, 8])
def test_prefill_then_decode_equals_teacher_forced(S0):
    """Deviation 16: the port's prefill of S0 tokens, then decode of the
    rest at a (B,) position, equals the reference's teacher-forced logits
    at every step; its rings hold the prompt's keys and values.  The
    reference's prefill gives the same last-token logits but empty rings,
    so its first decode step does not continue the decoder."""
    jcfg, cfg, jp, tp = _weights()
    toks, frames = _inputs(2, cfg)
    full = _j_logits(jcfg, jp, _jbatch(toks, frames))
    tl, tc = tapi.model_prefill(cfg, tp, _tbatch(toks[:, :S0], frames), S)
    _close(tl, full[:, S0 - 1], LOGIT_TOL, "prefill logits")
    assert bool(tc["self/k"][:, :, :S0].abs().amax(dim=(2, 3, 4)).gt(0).all())
    assert not bool(tc["self/k"][:, :, S0:].any())
    for t in range(S0, S):
        tl, tc = tapi.model_decode_step(
            cfg, tp, tc, torch.from_numpy(toks[:, t]).long(),
            torch.full((B,), t))
        _close(tl, full[:, t], LOGIT_TOL, f"decode {t}")

    jl, jc = _j_prefill(jcfg, jp, _jbatch(toks[:, :S0], frames), S)
    _close(jl, full[:, S0 - 1], LOGIT_TOL, "reference prefill logits")
    assert not np.asarray(jc["self"]["k"]).any()      # the empty rings
    jl_next, _ = _j_decode(jcfg, jp, jc, jnp.asarray(toks[:, S0]),
                           jnp.int32(S0))
    assert np.abs(np.asarray(jl_next) - np.asarray(full[:, S0])).max() > 1.0


def test_bfloat16_logits_and_decode_match_reference():
    jcfg, cfg, jp, tp = _weights("bfloat16")
    assert tp["dec/self/wq"].dtype == torch.bfloat16
    toks, frames = _inputs(3, cfg)
    got, _ = tapi.model_logits(cfg, tp, _tbatch(toks, frames))
    assert got.dtype == torch.bfloat16
    _close(got, _j_logits(jcfg, jp, _jbatch(toks, frames)), None, "logits")
    jc = japi.model_init_cache(jcfg, jp, B, S, {"frames": jnp.asarray(
        frames)})
    tc = tapi.model_init_cache(cfg, tp, B, S,
                               {"frames": torch.from_numpy(frames)})
    for t in range(3):
        jl, jc = _j_decode(jcfg, jp, jc, jnp.asarray(toks[:, t]),
                           jnp.int32(t))
        tl, tc = tapi.model_decode_step(cfg, tp, tc,
                                        torch.from_numpy(toks[:, t]).long(),
                                        t)
        _close(tl, jl, None, f"step {t}")


# ------------------------------------------------------------- training ---
def test_lm_loss_and_sgd_step_match_reference():
    """``lm_loss`` (the checkpointed route: each block recomputed in the
    backward) and one SGD step against the reference's."""
    jcfg, cfg, jp, tp = _weights()
    toks, frames = _inputs(4, cfg)
    jb = _jbatch(toks, frames)
    np.testing.assert_allclose(
        float(T.lm_loss(cfg, tp, _tbatch(toks, frames))),
        float(jax.jit(lambda p, b: J.lm_loss(jcfg, p, b))(jp, jb)),
        atol=1e-5, rtol=1e-6)
    rp, rl = jax.jit(lambda p, b: J.sgd_train_step(jcfg, p, b, 1e-2))(jp, jb)
    new, loss = T.sgd_train_step(cfg, tp, _tbatch(toks, frames), 1e-2)
    np.testing.assert_allclose(float(loss), float(rl), atol=1e-5, rtol=1e-6)
    ref = flat_ref(rp)
    assert set(new) == set(ref)
    moved = 0
    for k, v in ref.items():
        np.testing.assert_allclose(new[k].numpy(), v, atol=1e-5, rtol=0,
                                   err_msg=k)
        moved += not torch.equal(new[k], tp[k])
    assert moved == len(ref)            # every leaf takes a gradient
