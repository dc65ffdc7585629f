"""The port's mamba2-2.7b language model at smoke size against the
reference, from the reference's own ``init_lm`` carried across by
``convert``: full-sequence logits, prefill (last-token logits and the decode
cache) and decode steps; then the port's own invariants (prefill followed
by decode equals the full-sequence logits at every position); and each
block against the reference's block on its K5 route (the Pallas kernel in
interpret mode).

Tolerance: float32, atol 1e-4 with rtol 1e-5 on logits of order 100 (the
smoke model's tied unit-normal embedding), atol 1e-5 on cache leaves."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.models import api as japi
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.models import api as tapi
from repro_torch.models import transformer as TT
from repro_torch.models.base import param_count

from test_torch_convert import assert_flat_close, to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

JCFG = jget_config("mamba2-2.7b").smoke()
CFG = get_config("mamba2-2.7b").smoke()
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def weights():
    jp = jax.jit(lambda k: JT.init_lm(JCFG, k))(jax.random.PRNGKey(0))
    return jp, to_port(jp)


def _tokens(seed, B, S):
    return np.random.default_rng(seed).integers(0, CFG.vocab, (B, S)).astype(
        np.int32)


@functools.partial(jax.jit, static_argnums=(2,))
def _j_prefill(params, toks, seq_len):
    return JT.prefill(JCFG, params, toks, seq_len=seq_len)


_j_decode = jax.jit(lambda p, c, t, pos: JT.decode_step(JCFG, p, c, t, pos))
_j_logits = jax.jit(lambda p, t: JT.lm_logits(JCFG, p, t)[0])


def test_config_registry_and_layout(weights):
    jp, tp = weights
    assert get_config("mamba2-2.7b") == get_config("mamba2-2.7b")
    full = get_config("mamba2-2.7b")
    assert (full.d_model, full.n_layers, full.ssm_heads, full.vocab) == (
        2560, 64, 80, 50280)
    assert full.cdtype == torch.bfloat16 and CFG.cdtype == torch.float32
    assert list_archs() == jlist_archs()
    # every reference id resolves, the modality families among them
    assert get_config("phi-3-vision-4.2b").arch_type == "vlm"
    assert get_config("whisper-small").arch_type == "audio"
    # the port's own init has the reference's names, shapes and dtypes
    own = tapi.model_init(CFG, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    assert tuple(tp["blocks/s0_mix/w_z"].shape) == (2, 128, 256)
    assert param_count(tp) == sum(int(a.size)
                                  for a in jax.tree.leaves(jp))


def test_lm_logits_prefill_decode_match_reference(weights):
    jp, tp = weights
    toks = _tokens(0, 2, 37)                    # 37 = 2 chunks of 16 and 5
    want = np.asarray(_j_logits(jp, jnp.asarray(toks)))
    got, aux = tapi.model_logits(CFG, tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)
    assert float(aux) == 0.0

    jl, jc = _j_prefill(jp, jnp.asarray(toks), 48)
    tl, tc = tapi.model_prefill(CFG, tp, {"tokens": torch.from_numpy(toks)},
                                48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert_flat_close(tc, jc, what="prefill cache ", **CACHE_TOL)
    tc_from_ref = to_port(jc)                   # the reference's own cache
    for step in range(3):
        tok = _tokens(10 + step, 2, 1)[:, 0]
        jl, jc = _j_decode(jp, jc, jnp.asarray(tok), jnp.int32(37 + step))
        tl, tc = tapi.model_decode_step(CFG, tp, tc, torch.from_numpy(tok),
                                        37 + step)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        assert_flat_close(tc, jc, what=f"decode {step} ", **CACHE_TOL)
        if step == 0:               # the converted cache decodes the same
            # (written in place: tc_from_ref is not read again)
            _, nxt = TT.decode_step(CFG, tp, tc_from_ref,
                                    torch.from_numpy(tok), 37)
            assert_flat_close(nxt, jc, what="converted ", **CACHE_TOL)
    # an empty cache, as the reference's init_cache
    empty = tapi.model_init_cache(CFG, tp, 3, 48)
    jempty = convert.flatten_tree(jax.device_get(
        japi.model_init_cache(JCFG, jp, 3, 48)))
    assert {k: tuple(v.shape) for k, v in empty.items()} == {
        k: v.shape for k, v in jempty.items()}


@pytest.mark.parametrize("S", [1, 2, 20])
def test_prefill_then_decode_equals_full_logits(weights, S):
    """Inside the port: prefill the first S tokens, decode the rest one by
    one, and every step's logits equal the full-sequence logits there —
    including prompts shorter than the conv window (S = 1, 2)."""
    _, tp = weights
    toks = torch.from_numpy(_tokens(S, 2, 24)).long()
    full, _ = TT.lm_logits(CFG, tp, toks)
    logits, cache = TT.prefill(CFG, tp, toks[:, :S])
    torch.testing.assert_close(logits, full[:, S - 1], **LOGIT_TOL)
    for t in range(S, 24):
        logits, cache = TT.decode_step(CFG, tp, cache, toks[:, t], t)
        torch.testing.assert_close(logits, full[:, t], **LOGIT_TOL)


def test_ssd_kernel_route_equals_plain_route_on_cpu(weights):
    """Every block of the port (K5's plain version on CPU tensors) against
    the reference's ``_block_forward(use_ssd_kernel=True)`` (its Pallas K5
    in interpret mode) on the same hidden states, 40 = 2 chunks and 8."""
    jp, tp = weights
    x = np.random.default_rng(5).standard_normal(
        (3, 40, CFG.d_model)).astype(np.float32)
    j_block = jax.jit(lambda bp, h: JT._block_forward(
        JCFG, bp, h, None, 16, 16, use_ssd_kernel=True)[0])
    for b in range(CFG.n_blocks):
        jbp = jax.tree.map(lambda a: a[b], jp["blocks"])
        want = np.asarray(j_block(jbp, jnp.asarray(x)))
        got, aux = TT._block_forward(CFG, TT._block(tp, b), torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, **CACHE_TOL)
        assert float(aux) == 0.0


def test_unported_models_raise(weights, monkeypatch):
    _, tp = weights
    # the MoE FFN is ported: its init gives the reference's leaves
    moe = dict(arch_type="moe", block_pattern=(("attn", "moe"),), n_heads=4,
               n_kv_heads=4, head_dim=32, n_experts=4, d_ff=256)
    want = jax.eval_shape(lambda k: JT.init_lm(JCFG.replace(**moe), k),
                          jax.random.PRNGKey(0))
    own = TT.init_lm(CFG.replace(**moe), torch.Generator(), "cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == {
        "/".join(p.key for p in path): tuple(v.shape)
        for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    # the audio family is ported: its init gives the encoder-decoder's
    # leaves; a batch key the architecture does not take still raises
    audio = tapi.model_init(get_config("whisper-small").smoke(),
                            torch.Generator(), "cpu")
    assert {"enc/attn/wq", "dec/cross/wq", "pos_dec"} <= set(audio)
    with pytest.raises(ValueError, match="takes the batch keys"):
        tapi.model_logits(CFG, tp, {"tokens": torch.zeros((1, 4),
                                                          dtype=torch.long),
                                    "patches": None})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapi.model_init(CFG, torch.Generator())
