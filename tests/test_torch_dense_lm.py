"""The port's dense decoder family (qwen1.5-4b, qwen1.5-110b, gemma-7b,
phi3-medium-14b) at smoke size against the reference, from the reference's
own ``init_lm`` carried across by ``convert``: full-sequence logits, prefill
(last-token logits and the ring-buffer KV cache) and decode steps, in
float32 and in bfloat16; a grouped-query copy whose ring buffer wraps under
a sliding window; a batch whose rows decode at different positions, held
to one reference call per row; and the port's own invariants (prefill then
decode equals the full-sequence logits; the decode step writes the cache
in place).  Also the configs and the input shapes pinned equal to the
reference's, and the full-width qwen1.5-4b parameter count the card run
asserts.

The smoke configs all have G = 1 (4 heads over 4 KV heads), so the
grouped-query cases replace the head counts.

Tolerance: float32 atol 1e-4 with rtol 1e-5 on logits of order 100 (the
tied unit-normal embedding), atol 1e-5 on cache leaves; bfloat16 atol
2^-6 of each tensor's largest magnitude, two bf16 steps at the top of its
range (both sides round every product to bf16, in other orders)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.configs import shapes as jshapes
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config, list_archs, shapes
from repro_torch.models import api as tapi
from repro_torch.models import transformer as TT
from repro_torch.models.base import param_count

from test_torch_convert import assert_flat_close, flat_ref, to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

DENSE = ["qwen1.5-4b", "qwen1.5-110b", "gemma-7b", "phi3-medium-14b"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
BF16_STEPS = 2 ** -6


def _cfgs(arch, **kw):
    return (jget_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


@functools.lru_cache(maxsize=None)
def _weights(arch, dtype="float32", **kw):
    jcfg, cfg = _cfgs(arch, dtype=dtype, **kw)
    jp = jax.jit(lambda k: JT.init_lm(jcfg, k))(jax.random.PRNGKey(0))
    return jcfg, cfg, jp, to_port(jp)


def _tokens(seed, B, S, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@functools.partial(jax.jit, static_argnums=(0, 3))
def _j_prefill(cfg, params, toks, seq_len):
    return JT.prefill(cfg, params, toks, seq_len=seq_len)


@functools.partial(jax.jit, static_argnums=(0,))
def _j_decode(cfg, p, c, t, pos):
    return JT.decode_step(cfg, p, c, t, pos)


@functools.partial(jax.jit, static_argnums=(0,))
def _j_logits(cfg, p, t):
    return JT.lm_logits(cfg, p, t)[0]


def _f32(a):
    a = a.detach().float() if isinstance(a, torch.Tensor) else a
    return np.asarray(a, np.float32)


def _close(got, want, tol, what=""):
    """allclose for f32 (``tol``) or bf16 (None: two steps of the top)."""
    got, want = _f32(got), _f32(want)
    if tol is None:
        tol = dict(atol=BF16_STEPS * float(np.abs(want).max()), rtol=0.0)
    np.testing.assert_allclose(got, want, err_msg=what, **tol)


def _cache_close(tc, jc, tol, what=""):
    ref = flat_ref(jc)
    assert set(tc) == set(ref), (sorted(tc), sorted(ref))
    for k, v in ref.items():
        _close(tc[k], v, tol, f"{what}{k}")


# ----------------------------------------------------------------- configs --
def test_configs_and_shapes_pinned_to_reference():
    for arch in DENSE:
        want = dataclasses.asdict(jget_config(arch))
        del want["scan_unroll"]                 # an XLA dry-run switch
        assert dataclasses.asdict(get_config(arch)) == want, arch
        assert get_config(arch).pattern == (("attn", "mlp"),)
    assert shapes.SHAPES == {k: shapes.InputShape(**dataclasses.asdict(v))
                             for k, v in jshapes.SHAPES.items()}
    assert shapes.LONG_CONTEXT_WINDOW == jshapes.LONG_CONTEXT_WINDOW
    assert list_archs() == jlist_archs()        # all ten reference ids


def test_qwen_full_width_parameter_count():
    """The count chip_smoke.py asserts on the card: the reference's
    ``init_lm`` of qwen1.5-4b, counted without drawing it."""
    shapes_ = jax.eval_shape(lambda k: JT.init_lm(jget_config("qwen1.5-4b"),
                                                  k), jax.random.PRNGKey(0))
    leaves = jax.tree.leaves(shapes_)
    assert sum(int(a.size) for a in leaves) == 3_561_413_120
    assert sum(int(a.size) * a.dtype.itemsize for a in leaves) == \
        7_123_240_960
    # and the ring buffers of ServeEngine(slots=8, seq_budget=2112)
    cfg = get_config("qwen1.5-4b")
    assert 2 * cfg.n_blocks * 8 * 2112 * cfg.n_kv_heads * cfg.hd * 2 == \
        6_920_601_600


@pytest.mark.parametrize("arch", DENSE)
def test_init_layout_matches_reference(arch):
    _, cfg, jp, tp = _weights(arch)
    own = tapi.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in tp.items()}
    assert "blocks/s0_ffn/w_gate" in own or "blocks/s0_ffn/b_up" in own
    assert tuple(own["blocks/s0_mix/wq"].shape)[0] == cfg.n_blocks == 2
    assert param_count(tp) == sum(int(a.size) for a in jax.tree.leaves(jp))


# ---------------------------------------------------------- vs reference --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_logits_prefill_decode_match_reference(arch, dtype):
    jcfg, cfg, jp, tp = _weights(arch, dtype)
    ltol, ctol = ((LOGIT_TOL, CACHE_TOL) if dtype == "float32"
                  else (None, None))
    toks = _tokens(0, 2, 37)
    want = _j_logits(jcfg, jp, jnp.asarray(toks))
    got, aux = tapi.model_logits(cfg, tp, {"tokens": torch.from_numpy(toks)})
    _close(got, want, ltol, "logits")
    assert float(aux) == 0.0

    jl, jc = _j_prefill(jcfg, jp, jnp.asarray(toks), 48)
    tl, tc = tapi.model_prefill(cfg, tp, {"tokens": torch.from_numpy(toks)},
                                48)
    _close(tl, jl, ltol, "prefill logits")
    _cache_close(tc, jc, ctol, "prefill cache ")
    assert tuple(tc["s0/k"].shape) == (2, 2, 48, cfg.n_kv_heads, cfg.hd)
    for step in range(3):
        tok = _tokens(10 + step, 2, 1)[:, 0]
        jl, jc = _j_decode(jcfg, jp, jc, jnp.asarray(tok),
                           jnp.int32(37 + step))
        tl, tc = tapi.model_decode_step(cfg, tp, tc, torch.from_numpy(tok),
                                        37 + step)
        _close(tl, jl, ltol, f"decode {step} logits")
        _cache_close(tc, jc, ctol, f"decode {step} ")
    empty = tapi.model_init_cache(cfg, tp, 3, 48)
    assert {k: tuple(v.shape) for k, v in empty.items()} == {
        k: v.shape for k, v in flat_ref(JT.init_cache(jcfg, 3, 48)).items()}


@pytest.mark.parametrize("seq_len", [12, 24])
def test_grouped_query_sliding_window_ring_wrap(seq_len):
    """phi3-medium-14b's smoke copy with 4 heads over 2 KV heads (G = 2)
    and a 12-token sliding window: the (2, 20) prefill keeps the last 12
    keys rolled by 20 % 12, and 8 decode steps wrap the ring again."""
    jcfg, cfg, jp, tp = _weights("phi3-medium-14b", n_kv_heads=2,
                                 sliding_window=12)
    assert cfg.n_heads // cfg.n_kv_heads == 2
    toks = _tokens(1, 2, 28)
    want = _j_logits(jcfg, jp, jnp.asarray(toks))
    got, _ = TT.lm_logits(cfg, tp, torch.from_numpy(toks))
    _close(got, want, LOGIT_TOL, "logits")
    jl, jc = _j_prefill(jcfg, jp, jnp.asarray(toks[:, :20]), seq_len)
    tl, tc = TT.prefill(cfg, tp, torch.from_numpy(toks[:, :20]), seq_len)
    _close(tl, jl, LOGIT_TOL, "prefill logits")
    _cache_close(tc, jc, CACHE_TOL, "prefill ")
    assert tc["s0/k"].shape[2] == 12
    for t in range(20, 28):
        jl, jc = _j_decode(jcfg, jp, jc, jnp.asarray(toks[:, t]),
                           jnp.int32(t))
        tl, tc = TT.decode_step(cfg, tp, tc, torch.from_numpy(toks[:, t]), t)
        _close(tl, jl, LOGIT_TOL, f"decode {t}")
        _cache_close(tc, jc, CACHE_TOL, f"decode {t} ")
        _close(tl, want[:, t], LOGIT_TOL, f"full-sequence logits at {t}")


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "phi3-medium-14b"])
def test_rows_at_different_positions_match_per_row_reference(arch):
    """Three prompts of 5, 11 and 16 tokens prefilled alone into rings of
    16 slots (the 16-token one wraps on its first step), stacked into one
    batch, decoded 4 steps with a (3,) position vector: each row equals the
    reference decoding that row alone at its scalar position."""
    kw = dict(n_kv_heads=2) if arch == "phi3-medium-14b" else {}
    jcfg, cfg, jp, tp = _weights(arch, **kw)
    lens = (5, 11, 16)
    toks = _tokens(2, 3, 20)
    jcs, tcs = [], []
    for b, S in enumerate(lens):
        jcs.append(_j_prefill(jcfg, jp, jnp.asarray(toks[b:b + 1, :S]),
                              16)[1])
        tcs.append(TT.prefill(cfg, tp, torch.from_numpy(
            toks[b:b + 1, :S]), 16)[1])
    tc = {k: torch.cat([c[k] for c in tcs], dim=1) for k in tcs[0]}
    pos = torch.tensor(lens)
    for step in range(4):
        tok = _tokens(20 + step, 3, 1)[:, 0]
        tl, tc = TT.decode_step(cfg, tp, tc, torch.from_numpy(tok), pos)
        for b in range(3):
            jl, jcs[b] = _j_decode(jcfg, jp, jcs[b], jnp.asarray(tok[b:b + 1]),
                                   jnp.int32(int(pos[b])))
            _close(tl[b:b + 1], jl, LOGIT_TOL, f"step {step} row {b}")
            _cache_close({k: v[:, b:b + 1] for k, v in tc.items()}, jcs[b],
                         CACHE_TOL, f"step {step} row {b} ")
        pos = pos + 1


# ----------------------------------------------------------- invariants --
@pytest.mark.parametrize("S", [1, 5, 16])
def test_prefill_then_decode_equals_full_logits(S):
    """Inside the port: prefill S tokens, decode the rest one by one, and
    every step's logits equal the full-sequence logits there."""
    _, cfg, _, tp = _weights("qwen1.5-4b")
    toks = torch.from_numpy(_tokens(S, 2, 24)).long()
    full, _ = TT.lm_logits(cfg, tp, toks)
    logits, cache = TT.prefill(cfg, tp, toks[:, :S], 24)
    torch.testing.assert_close(logits, full[:, S - 1], **LOGIT_TOL)
    for t in range(S, 24):
        logits, cache = TT.decode_step(cfg, tp, cache, toks[:, t], t)
        torch.testing.assert_close(logits, full[:, t], **LOGIT_TOL)


def test_decode_writes_the_cache_in_place():
    """The step returns the dict it was given, its tensors the same storage;
    each row's K/V changed only at slot pos % W.  A caller who needs the old
    cache clones it first (done here)."""
    _, cfg, _, tp = _weights("qwen1.5-4b")
    _, cache = TT.prefill(cfg, tp, torch.from_numpy(_tokens(3, 2, 10)), 8)
    before = {k: v.clone() for k, v in cache.items()}
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    _, out = TT.decode_step(cfg, tp, cache, torch.tensor([1, 2]),
                            torch.tensor([10, 13]))
    assert out is cache and {k: v.data_ptr() for k, v in out.items()} == ptrs
    for k, v in out.items():
        changed = (v != before[k]).flatten(3).any(-1)       # (nb, B, W)
        want = torch.zeros_like(changed)
        want[:, 0, 10 % 8] = want[:, 1, 13 % 8] = True
        assert torch.equal(changed, want), k


def test_convert_carries_dense_weights_and_kv_cache():
    """The reference's attention/MLP leaves and its KV cache cross to the
    port's flat names and back unchanged (bf16 included)."""
    jcfg, cfg, jp, tp = _weights("qwen1.5-4b", "bfloat16")
    assert {"blocks/s0_mix/wq", "blocks/s0_mix/bq", "blocks/s0_ffn/w_gate",
            "blocks/s0_n2/scale", "embed/tok"} <= set(tp)
    back = convert.to_numpy_tree(tp)
    for k, v in flat_ref(jp).items():
        np.testing.assert_array_equal(convert.flatten_tree(back)[k],
                                      v.astype(np.float32))
    _, jc = _j_prefill(jcfg, jp, jnp.asarray(_tokens(4, 2, 9)), 12)
    tc = to_port(jc)
    assert sorted(tc) == ["s0/k", "s0/v"]
    assert tc["s0/k"].dtype == torch.bfloat16
    again = convert.from_numpy_tree(convert.to_numpy_tree(tc), "cpu")
    for k in tc:
        assert torch.equal(again[k], tc[k].float())
