"""The port's LLM-scale DS-FL round (`repro_torch.core.llm_dsfl`) against
the reference's `repro.core.llm_dsfl` on ``mamba2-2.7b``'s smoke config
(2 layers, d 128, vocab 512, chunk 16, float32), from the reference's own
client-stacked init carried across by ``convert``: the open-batch
prediction, the teacher (ERA, SA, weighted, two-level, top-k), one and two
rounds dense, weighted and participation-sparse (the top-k round's parts:
its compression, densify and teacher), and ``microbatches=2``,
each with the port's kernel route (``use_kernel=True``: the kernels' plain
versions on the CPU) and without.  Then the port's own invariants: sparse
equals dense weighted bitwise, microbatches match the full batch.

Tolerances: the f32 probabilities and the f32 teacher at atol 1e-6; the
bf16 uploads and teacher within one bf16 step of the value (rtol 2^-8: the
f32 values agree to 1e-6, and one that sits on a bf16 rounding boundary may
round the other way); leaves and loss after one round at atol 1e-5, after
two at 1e-4 (loss values are about 70, so the loss takes rtol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import aggregation as jagg
from repro.core import hierarchy as jhier
from repro.core import llm_dsfl as J
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.core import llm_dsfl as T
from repro_torch.core.aggregation import topk_compress
from repro_torch.models import api as tapi

from test_torch_convert import flat_ref, to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

JCFG = jget_config("mamba2-2.7b").smoke()
CFG = get_config("mamba2-2.7b").smoke()
K, B, S = 3, 2, 32
BF16_STEP = 2.0 ** -8
ROUND_TOL = {1: 1e-5, 2: 1e-4}
MASK = np.array([1.0, 0.0, 1.0], np.float32)


@pytest.fixture(scope="module")
def setup():
    jst = jax.jit(jax.vmap(lambda k: japi.model_init(JCFG, k)))(
        jax.random.split(jax.random.PRNGKey(0), K))
    rng = np.random.default_rng(0)
    pt = rng.integers(0, CFG.vocab, (K, B, S))
    ot = rng.integers(0, CFG.vocab, (B, S))
    return dict(
        jst=jst, tst=to_port(jst),
        jpb={"tokens": jnp.asarray(pt, jnp.int32)},
        job={"tokens": jnp.asarray(ot, jnp.int32)},
        tpb={"tokens": torch.as_tensor(pt)},
        tob={"tokens": torch.as_tensor(ot)})


def assert_leaves_close(port: dict, ref_tree, atol):
    ref = flat_ref(ref_tree)
    assert set(port) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(port[k].float().numpy(), v, atol=atol,
                                   rtol=0, err_msg=k)


def assert_loss_close(port, ref, atol):
    np.testing.assert_allclose(float(port), float(ref), atol=atol, rtol=1e-6)


def assert_bf16_close(port: torch.Tensor, ref):
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-6, rtol=BF16_STEP)


# ------------------------------------------------------------ prediction ----
@pytest.fixture(scope="module")
def ref_predict(setup):
    """Client 1's bf16 uploads and f32 logits in the reference."""
    jp1 = jax.tree.map(lambda a: a[1], setup["jst"])
    return jax.jit(lambda p, b: (J.predict_open_probs(JCFG, p, b),
                                 japi.model_logits(JCFG, p, b)[0]))(
        jp1, setup["job"])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_predict_open_probs_matches_reference(setup, ref_predict, use_kernel):
    ref, jl = ref_predict
    out = T.predict_open_probs(CFG, T.client(setup["tst"], 1), setup["tob"],
                               use_kernel)
    assert tuple(out.shape) == (B, S, CFG.vocab)
    assert_bf16_close(out, ref)
    # the f32 distributions the uploads round from
    with torch.no_grad():
        tl, _ = tapi.model_logits(CFG, T.client(setup["tst"], 1),
                                  setup["tob"], use_ssd_kernel=use_kernel)
    np.testing.assert_allclose(torch.softmax(tl, -1).numpy(),
                               np.asarray(jax.nn.softmax(jl, -1)), atol=1e-6)


# --------------------------------------------------------------- teacher ----
def _uploads(seed, dtype=torch.bfloat16):
    """(K, B, S, V) client distributions, the same values in both packages
    (rounded to bf16 by torch, carried across exactly through f32)."""
    g = torch.Generator().manual_seed(seed)
    p = torch.softmax(4 * torch.randn((K, B, S, CFG.vocab), generator=g),
                      -1).to(dtype)
    return p, jnp.asarray(p.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


TEACHERS = {
    "era": (dict(), None),
    "sa": (dict(aggregation="sa"), None),
    "weighted_era": (dict(), MASK * 0.7),
    "weighted_sa": (dict(aggregation="sa"), MASK * 0.7),
    "two_level_era": (dict(agg_edges=2), None),
    "two_level_weighted_sa": (dict(aggregation="sa", agg_edges=2),
                              np.array([0.2, 0.0, 0.5], np.float32)),
}


def _ref_f32_teacher(probs, kw, w):
    """The reference's teacher before its bf16 cast (its own functions)."""
    T_ = 0.1
    era = kw.get("aggregation", "era") == "era"
    if kw.get("agg_edges", 1) > 1:
        w = jnp.ones((K,), jnp.float32) if w is None else jnp.asarray(w)
        f = jhier.hierarchical_weighted_era if era else \
            jhier.hierarchical_weighted_sa
        return f(probs, w, T_, kw["agg_edges"]) if era else \
            f(probs, w, kw["agg_edges"])
    if w is None:
        return jagg.era(probs, T_) if era else jagg.sa(probs)
    return (jagg.weighted_era(probs, jnp.asarray(w), T_) if era
            else jagg.weighted_sa(probs, jnp.asarray(w)))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kind", sorted(TEACHERS))
def test_teacher_matches_reference(kind, use_kernel):
    kw, w = TEACHERS[kind]
    tp, jp = _uploads(1)
    hp = T.LLMDsflHP(use_kernel=use_kernel, **kw)
    tw = None if w is None else torch.as_tensor(w)
    out = T._aggregate_teacher(tp, hp, tw)
    ref = J._aggregate_teacher(jp, J.LLMDsflHP(**kw),
                               None if w is None else jnp.asarray(w))
    assert tuple(out.shape) == (B, S, CFG.vocab)
    assert_bf16_close(out, ref)
    # before the cast: the (K, B*S, V) view through the port's aggregation
    f32 = T._aggregate(tp, hp, tw)
    np.testing.assert_allclose(f32.numpy(), np.asarray(_ref_f32_teacher(
        jp, kw, w)), atol=1e-6)


def test_topk_teacher_matches_reference():
    """The top-k exchange: the clients' (values, indices) and the densified
    uploads, from the same uploads.  Each token's distribution is geometric
    over a random ranking of the vocabulary (ratio e^-1/2), so no two
    entries tie in bf16 and top-k has one answer in both packages."""
    g = torch.Generator().manual_seed(2)
    rank = torch.argsort(torch.rand((K, B, S, CFG.vocab), generator=g), -1)
    tp = torch.softmax(-0.5 * rank.float(), -1).to(torch.bfloat16)
    jp = jnp.asarray(tp.float().numpy()).astype(jnp.bfloat16)
    tv, ti = topk_compress(tp, 8)
    jv, ji = jax.vmap(lambda p: jagg.topk_compress(p, 8))(jp)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6)
    dense = torch.zeros(tv.shape[:-1] + (CFG.vocab,)).scatter(-1, ti, tv)
    jdense = jnp.einsum("cbsk,cbskv->cbsv", jv, (
        jnp.arange(CFG.vocab)[None, None, None, None] == ji[..., None]
    ).astype(jnp.float32))
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense))


# ----------------------------------------------------------------- rounds ----
def _jit_round(hp, weights=None, mask=None):
    return jax.jit(lambda p, a, b: J.dsfl_round_step(
        JCFG, p, a, b, hp, weights=weights, mask=mask))


ROUND_KINDS = {
    "era": (dict(lr=5e-3), None),
    "weighted_era": (dict(lr=5e-3), MASK * 0.7),
}


@pytest.fixture(scope="module")
def ref_rounds(setup):
    """The reference's first two rounds of each kind (one compile each)."""
    out = {}
    for kind, (kw, w) in ROUND_KINDS.items():
        jw = None if w is None else jnp.asarray(w)
        f = _jit_round(J.LLMDsflHP(**kw), jw, None if w is None
                       else jnp.asarray(MASK))
        r1 = f(setup["jst"], setup["jpb"], setup["job"])
        r2 = f(r1[0], setup["jpb"], setup["job"])
        out[kind] = (r1, r2)
    return out


def _port_rounds(setup, kind, use_kernel, active_budget=None):
    kw, w = ROUND_KINDS[kind]
    hp = T.LLMDsflHP(use_kernel=use_kernel, **kw)
    tw = None if w is None else torch.as_tensor(w)
    tm = None if w is None else torch.as_tensor(MASK)
    step = lambda st: T.dsfl_round_step(CFG, st, setup["tpb"], setup["tob"],
                                        hp, weights=tw, mask=tm,
                                        active_budget=active_budget)
    r1 = step(setup["tst"])
    return r1, step(r1[0])


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kind", sorted(ROUND_KINDS))
def test_rounds_match_reference(setup, ref_rounds, kind, use_kernel):
    for n, (port, ref) in enumerate(zip(_port_rounds(setup, kind, use_kernel),
                                        ref_rounds[kind]), start=1):
        assert_leaves_close(port[0], ref[0], ROUND_TOL[n])
        assert_loss_close(port[1], ref[1], ROUND_TOL[n])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sparse_rounds_equal_dense_weighted_bitwise_and_reference(
        setup, ref_rounds, use_kernel):
    """``active_budget=2`` computes the two participants of three clients:
    the same bits as the dense weighted round (the absent client keeps its
    parameters), and so within tolerance of the reference's."""
    dense = _port_rounds(setup, "weighted_era", use_kernel)
    sparse = _port_rounds(setup, "weighted_era", use_kernel, active_budget=2)
    for n, (d, s, ref) in enumerate(zip(dense, sparse,
                                        ref_rounds["weighted_era"]), 1):
        for k in d[0]:
            assert torch.equal(d[0][k], s[0][k]), (n, k)
        assert torch.equal(d[1], s[1])
        assert_leaves_close(s[0], ref[0], ROUND_TOL[n])
        assert_loss_close(s[1], ref[1], ROUND_TOL[n])
    for k, v in sparse[1][0].items():       # client 1 was absent twice
        assert torch.equal(v[1], setup["tst"][k][1]), k


@pytest.mark.parametrize("use_kernel", [False, True])
def test_round_halves_compose_to_the_round(setup, use_kernel):
    hp = T.LLMDsflHP(lr=5e-3, use_kernel=use_kernel)
    full = T.dsfl_round_step(CFG, setup["tst"], setup["tpb"], setup["tob"], hp)
    infl = T.dsfl_exchange(CFG, setup["tst"], setup["tob"], hp)
    half = T.dsfl_round_finish(CFG, setup["tst"], setup["tpb"], setup["tob"],
                               infl, hp)
    for k in full[0]:
        assert torch.equal(full[0][k], half[0][k]), k
    assert torch.equal(full[1], half[1])


# ----------------------------------------------------------- microbatches ----
@pytest.fixture(scope="module")
def ref_microbatched(setup):
    """The reference's client-0 step at ``microbatches=2`` on a teacher
    made of client 0's uploads of `_uploads(3)`."""
    _, jp = _uploads(3)
    hp2 = J.LLMDsflHP(lr=1e-2, microbatches=2)
    return jax.jit(lambda p, a, b, t: J.dsfl_client_step(
        JCFG, p, a, b, t, hp2))(
        jax.tree.map(lambda a: a[0], setup["jst"]),
        jax.tree.map(lambda a: a[0], setup["jpb"]), setup["job"], jp[0])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_microbatches_match_reference_and_full_batch(setup, ref_microbatched,
                                                     use_kernel):
    """``microbatches=2``: fp32 gradient accumulators over two halves of
    the batch; against the reference's scan, and (the port's invariant)
    within rounding of the full-batch step, since equal halves' mean CE is
    the full batch's."""
    teacher_t = _uploads(3)[0][0]
    params_t = T.client(setup["tst"], 0)
    pb_t = T.client(setup["tpb"], 0)
    ref_p, ref_l = ref_microbatched
    out = {m: T.dsfl_client_step(CFG, params_t, pb_t, setup["tob"],
                                 teacher_t, T.LLMDsflHP(
                                     lr=1e-2, microbatches=m,
                                     use_kernel=use_kernel))
           for m in (1, 2)}
    assert_leaves_close(out[2][0], ref_p, 1e-5)
    assert_loss_close(out[2][1], ref_l, 1e-5)
    for k in out[1][0]:
        np.testing.assert_allclose(out[2][0][k].numpy(), out[1][0][k].numpy(),
                                   atol=1e-5, err_msg=k)
    assert_loss_close(out[2][1], out[1][1], 1e-5)
