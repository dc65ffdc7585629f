"""The port's VLM (phi-3-vision-4.2b: the dense decoder with a patch
projector whose outputs are prepended to the token embeddings) against the
reference's `repro.models.transformer`, on phi-3-vision-4.2b's smoke config
(2 layers, d 128, 4 heads of 32, 16 patches, vocabulary 512, float32) from
the reference's own ``init_lm`` carried across by ``convert``, with tokens
and patch features drawn with numpy: the projector's leaf and draw, the
text positions' logits with and without patches (float32 and bfloat16),
the patches changing the text logits, prefill with patches and decode
from S0 + n_patches (logits and the ring buffers at every step), the
batch keys the API takes, and the full-width count chip_smoke.py asserts.

Tolerance as in tests/test_torch_dense_lm.py: float32 logits atol 1e-4
with rtol 1e-5, cache leaves atol 1e-5; bfloat16 atol 2^-6 of the largest
magnitude."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import api as tapi
from repro_torch.models import transformer as TT
from repro_torch.models.base import param_count

from test_torch_convert import to_port
from test_torch_dense_lm import CACHE_TOL, LOGIT_TOL, _cache_close, _close
from test_torch_convert import one_intra_op_thread  # noqa: F401

ARCH = "phi-3-vision-4.2b"
B, S = 2, 12
P = 16                                  # the smoke config's patches


@functools.lru_cache(maxsize=None)
def _weights(dtype="float32"):
    jcfg = jget_config(ARCH).smoke().replace(dtype=dtype)
    cfg = get_config(ARCH).smoke().replace(dtype=dtype)
    jp = jax.jit(lambda k: JT.init_lm(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, to_port(jp)


def _inputs(seed, cfg):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, P, cfg.d_model)).astype(np.float32)
    return toks, patches


_j_logits = jax.jit(lambda cfg, p, t, pe: JT.lm_logits(cfg, p, t, pe)[0],
                    static_argnums=0)
_j_prefill = jax.jit(lambda cfg, p, t, pe, n: JT.prefill(cfg, p, t, pe, n),
                     static_argnums=(0, 4))
_j_decode = jax.jit(lambda cfg, p, c, t, pos: JT.decode_step(cfg, p, c, t,
                                                             pos),
                    static_argnums=0)


def test_config_and_projector_match_reference():
    """The config; the port's init has the reference's leaves, the
    projector among them, drawn with the reference's scale d^-1/2."""
    jcfg, cfg, jp, tp = _weights()
    want = dataclasses.asdict(jget_config(ARCH))
    del want["scan_unroll"]                     # an XLA dry-run switch
    assert dataclasses.asdict(get_config(ARCH)) == want
    own = tapi.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    w = own["patch_proj/w"]
    assert tuple(w.shape) == (128, 128)
    np.testing.assert_allclose(float(w.std()), 128 ** -0.5, rtol=0.05)
    assert "patch_proj/w" not in tapi.model_init(
        get_config("phi3-medium-14b").smoke(), torch.Generator(), "cpu")


def test_full_width_parameter_count():
    """The count chip_smoke.py asserts on the card: the reference's
    ``init_lm`` of phi-3-vision-4.2b, counted without drawing it, and the
    port's, made under fake tensors."""
    shapes = jax.eval_shape(lambda k: JT.init_lm(jget_config(ARCH), k),
                            jax.random.PRNGKey(0))
    assert sum(int(a.size) for a in jax.tree.leaves(shapes)) == \
        3_732_016_128
    with FakeTensorMode():
        own = tapi.model_init(get_config(ARCH), torch.Generator(), "cpu")
        assert param_count(own) == 3_732_016_128
        got = {k: tuple(v.shape) for k, v in own.items()}
    assert got == {"/".join(p.key for p in path): tuple(v.shape)
                   for path, v in jax.tree_util.tree_flatten_with_path(
                       shapes)[0]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_logits_with_and_without_patches_match_reference(dtype):
    jcfg, cfg, jp, tp = _weights(dtype)
    tol = LOGIT_TOL if dtype == "float32" else None
    toks, patches = _inputs(0, cfg)
    got, aux = tapi.model_logits(cfg, tp, {
        "tokens": torch.from_numpy(toks).long(),
        "patches": torch.from_numpy(patches)})
    assert tuple(got.shape) == (B, S, cfg.vocab) and float(aux) == 0.0
    _close(got, _j_logits(jcfg, jp, jnp.asarray(toks), jnp.asarray(patches)),
           tol, "with patches")
    alone, _ = tapi.model_logits(cfg, tp, {
        "tokens": torch.from_numpy(toks).long()})
    _close(alone, _j_logits(jcfg, jp, jnp.asarray(toks), None), tol,
           "text only")


def test_patches_change_text_logits():
    """As the reference's tests/test_models.py: shifting the patch features
    moves the text positions' logits."""
    _, cfg, _, tp = _weights()
    toks, patches = _inputs(1, cfg)
    t = torch.from_numpy(toks).long()
    pe = torch.from_numpy(patches)
    l1, _ = TT.lm_logits(cfg, tp, t, extra_embeds=pe)
    l2, _ = TT.lm_logits(cfg, tp, t, extra_embeds=pe + 1.0)
    assert tuple(l1.shape) == (B, S, cfg.vocab)
    assert not torch.allclose(l1, l2)


@pytest.mark.parametrize("S0", [1, 8])
def test_prefill_with_patches_then_decode_matches_reference(S0):
    """A prefill of P patches and S0 tokens into rings of P + S slots, then
    decode at positions S0 + P onwards: logits and rings against the
    reference after every step, and each step's logits equal to the
    full-sequence text logits there."""
    jcfg, cfg, jp, tp = _weights()
    toks, patches = _inputs(2, cfg)
    full = _j_logits(jcfg, jp, jnp.asarray(toks), jnp.asarray(patches))
    jl, jc = _j_prefill(jcfg, jp, jnp.asarray(toks[:, :S0]),
                        jnp.asarray(patches), P + S)
    tl, tc = tapi.model_prefill(cfg, tp, {
        "tokens": torch.from_numpy(toks[:, :S0]).long(),
        "patches": torch.from_numpy(patches)}, P + S)
    _close(tl, jl, LOGIT_TOL, "prefill logits")
    _close(tl, full[:, S0 - 1], LOGIT_TOL, "prefill vs full")
    _cache_close(tc, jc, CACHE_TOL, "prefill ")
    assert tuple(tc["s0/k"].shape) == (2, B, P + S, 4, 32)
    for t in range(S0, S):
        jl, jc = _j_decode(jcfg, jp, jc, jnp.asarray(toks[:, t]),
                           jnp.int32(t + P))
        tl, tc = tapi.model_decode_step(cfg, tp, tc,
                                        torch.from_numpy(toks[:, t]).long(),
                                        torch.full((B,), t + P))
        _close(tl, jl, LOGIT_TOL, f"decode {t}")
        _close(tl, full[:, t], LOGIT_TOL, f"decode {t} vs full")
        _cache_close(tc, jc, CACHE_TOL, f"decode {t} ")


def test_batch_keys_the_architecture_does_not_take_raise():
    _, cfg, _, tp = _weights()
    toks, patches = _inputs(3, cfg)
    bad = {"tokens": torch.from_numpy(toks).long(),
           "frames": torch.from_numpy(patches)}
    with pytest.raises(ValueError, match="takes the batch keys"):
        tapi.model_logits(cfg, tp, bad)
    with pytest.raises(ValueError, match="takes the batch keys"):
        tapi.model_prefill(cfg, tp, bad)
