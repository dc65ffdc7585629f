"""The MoE architectures at smoke size against the reference, from one
set of weights in both layouts (the port's ``init_lm``, whose leaves are
the reference's by name, shape and dtype, carried into the reference's
nested tree by ``convert``; the reference's own init of Jamba alone takes
10 s to compile): llama4-scout
(16 experts top-1, cut to 4 by ``.smoke()``), llama4-maverick (a dense and
an MoE layer a block) and jamba (Mamba, attention, MLP and MoE sub-layers
in a period of 8).  Full-sequence logits and the load-balance loss,
prefill and decode steps, the port's `ServeEngine` against the reference's
(the same weights, prompts and slots), the lockstep serve, ``lm_loss`` and
one ``sgd_train_step``.  Every comparison runs at the configs' own
capacity factor (1.25), where tokens drop: the tests count the dropped
(token, choice) pairs through `moe.route` and require some.

Weights: the embedding scaled by 0.1 (at unit scale greedy decoding
repeats the last prompt token, a weak check of token identity).
Tolerance: float32, logits atol 1e-4 with rtol 1e-5 (the dense family's),
cache leaves and parameters atol 1e-5 with rtol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs as jlist_archs
from repro.core import llm_dsfl as JL
from repro.launch.serve import serve as j_lockstep
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JEngine
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.core import llm_dsfl as TL
from repro_torch.launch.serve import serve as t_lockstep
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.serve import Request, ServeEngine

from test_torch_convert import assert_flat_close, to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

ARCHS = ["llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
         "jamba-1.5-large-398b"]
LOGIT_TOL = dict(atol=1e-4, rtol=1e-5)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
BUCKETS, BUDGET = (8, 16), 48


class Model:
    def __init__(self, arch):
        self.jcfg = jget_config(arch).smoke()
        self.cfg = get_config(arch).smoke()
        tp = TT.init_lm(self.cfg, torch.Generator().manual_seed(0), "cpu")
        tp["embed/tok"].mul_(0.1)
        self.tp = tp
        self.jp = jax.tree.map(jnp.asarray, convert.to_numpy_tree(tp))

    def params(self):
        """A private copy of the port's weights."""
        return {k: v.clone() for k, v in self.tp.items()}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return Model(request.param)


@pytest.fixture
def drops(monkeypatch):
    """Counts of (token, choice) pairs the port's MoE FFNs route and drop
    while the test runs."""
    seen = {"routed": 0, "dropped": 0}
    route = TM.route

    def counting(p, cfg, xg):
        out = route(p, cfg, xg)
        seen["routed"] += out[3].numel()
        seen["dropped"] += int((~out[3]).sum())
        return out

    monkeypatch.setattr(TM, "route", counting)
    return seen


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape)


def _prompts(cfg, lens, seed=3):
    g = np.random.default_rng(seed)
    return [tuple(int(t) for t in g.integers(0, cfg.vocab, size=n))
            for n in lens]


def _drain(engine, d=1):
    out, now = [], 0.0
    while engine.n_active:
        now += 1.0
        engine.step(now, decode_chunk=d)
        out.extend(engine.pop_completed())
    return {r.id: r.tokens for r in out}


def test_configs_pinned_to_reference():
    for arch in ARCHS:
        want = dataclasses.asdict(jget_config(arch))
        del want["scan_unroll"]                 # an XLA dry-run switch
        assert dataclasses.asdict(get_config(arch)) == want, arch
    assert list_archs() == jlist_archs()        # all ten reference ids


def test_init_matches_reference_layout(model):
    """The port's init has the reference's leaves (names, shapes, dtypes);
    the reference's is only traced, not drawn."""
    shapes = jax.eval_shape(lambda k: JT.init_lm(model.jcfg, k),
                            jax.random.PRNGKey(0))
    want = {"/".join(k.key for k in path): (tuple(v.shape), str(v.dtype))
            for path, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in model.tp.items()} == want
    assert to_port(model.jp).keys() == model.tp.keys()


def test_logits_and_aux_match_reference(model, drops):
    toks = _tokens(model.cfg, (2, 32))
    jl, ja = JT.lm_logits(model.jcfg, model.jp, jnp.asarray(toks),
                          remat=False)
    with torch.no_grad():
        tl, ta = TT.lm_logits(model.cfg, model.tp, torch.from_numpy(toks))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    assert abs(float(ta) - float(ja)) <= 1e-5
    assert float(ta) > 0 and drops["dropped"] > 0


def test_prefill_and_decode_match_reference(model, drops):
    """A (2, 16) prefill into rings of 24, then 4 decode steps."""
    toks = _tokens(model.cfg, (2, 20), seed=1)
    jlog, jc = JT.prefill(model.jcfg, model.jp, jnp.asarray(toks[:, :16]),
                          seq_len=24)
    jstep = jax.jit(lambda p, c, t, pos: JT.decode_step(model.jcfg, p, c, t,
                                                        pos))
    with torch.no_grad():
        tlog, tc = TT.prefill(model.cfg, model.tp,
                              torch.from_numpy(toks[:, :16]), 24)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   **LOGIT_TOL)
        assert_flat_close(tc, jc, what="prefill ", **CACHE_TOL)
        for i in range(4):
            pos = 16 + i
            jlog, jc = jstep(model.jp, jc, jnp.asarray(toks[:, pos]),
                             jnp.int32(pos))
            tlog, tc = TT.decode_step(model.cfg, model.tp, tc,
                                      torch.from_numpy(toks[:, pos]), pos)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       **LOGIT_TOL)
            assert_flat_close(tc, jc, what=f"decode {i} ", **CACHE_TOL)
    assert drops["dropped"] > 0


def test_engine_matches_reference_engine(model, drops):
    """Staggered requests (prefilled through bucket 8, tails forced through
    decode) through both engines: the same greedy tokens, at the default
    capacity.  Both route each slot's decode token as a group of its own
    (the reference vmaps its step over the slots); the prefills drop.
    (Prompts shorter than every bucket are left out: for Jamba's Mamba
    layers the reference keeps another conv window there, ROADMAP's
    reference caveats.)"""
    prompts = _prompts(model.cfg, (9, 12, 15))
    jeng = JEngine(model.jcfg, model.jp, slots=3, seq_budget=BUDGET,
                   buckets=BUCKETS)
    teng = ServeEngine(model.cfg, model.params(), slots=3, seq_budget=BUDGET,
                       buckets=BUCKETS, device="cpu")
    got = []
    for eng, req in ((jeng, JRequest), (teng, Request)):
        eng.insert(req(id=0, tokens=prompts[0], max_new_tokens=6))
        eng.step(1.0)
        eng.insert(req(id=1, tokens=prompts[1], max_new_tokens=6))
        eng.step(2.0)
        eng.insert(req(id=2, tokens=prompts[2], max_new_tokens=6))
        got.append(_drain(eng))
    assert got[1] == got[0]
    assert len({t for toks in got[0].values() for t in toks}) > 6
    assert drops["dropped"] > 0


def test_lockstep_serve_matches_reference(model, drops):
    """The lockstep path (one (3, 16) prefill, then batched decode steps)
    groups the rows' tokens together in both packages."""
    toks = _tokens(model.cfg, (3, 16), seed=2)
    base, _ = j_lockstep(model.jcfg, model.jp,
                         {"tokens": jnp.asarray(toks, jnp.int32)}, 6, 22)
    got, _ = t_lockstep(model.cfg, model.params(),
                        {"tokens": torch.from_numpy(toks)}, 6, 22)
    np.testing.assert_array_equal(got.numpy(), np.asarray(base))
    assert drops["dropped"] > 0


def test_lm_loss_and_sgd_step_match_reference(model):
    """CE + 0.01 x the load-balance loss, and one SGD step through the
    checkpointed blocks (each sub-layer its own region where the pattern
    has more than one)."""
    batch = {"tokens": _tokens(model.cfg, (2, 16), seed=4)}
    jbatch = {"tokens": jnp.asarray(batch["tokens"], jnp.int32)}
    tbatch = {"tokens": torch.from_numpy(batch["tokens"])}
    jnew, jl = jax.jit(lambda p, b: JL.sgd_train_step(model.jcfg, p, b,
                                                      0.05))(model.jp, jbatch)
    tloss = TL.lm_loss(model.cfg, model.tp, tbatch)
    tnew, tl = TL.sgd_train_step(model.cfg, model.tp, tbatch, 0.05)
    assert abs(float(tloss) - float(jl)) <= 1e-5
    assert abs(float(tl) - float(jl)) <= 1e-5
    with torch.no_grad():                       # the aux term is real
        _, aux = TT.lm_logits(model.cfg, model.tp, tbatch["tokens"])
        ce = TL.lm_loss(model.cfg, model.tp, tbatch, aux_weight=0.0)
    assert float(aux) > 0
    assert abs(float(tloss) - (float(ce) + 0.01 * float(aux))) <= 1e-6
    assert_flat_close(tnew, jnew, what="sgd ", **CACHE_TOL)


@pytest.mark.parametrize("cf", ["default", "full"])
def test_batched_prefill_each_alone_needs_full_capacity(cf):
    """llama4-scout: four same-bucket prompts through one `insert_batch`
    equal each served alone only where no choice can drop, at capacity
    factor >= n_experts / top_k (a group's capacity is then its size).
    Below it the rows of one prefill shot share their MoE groups and each
    expert's capacity, so which of a row's choices drop depends on the
    other rows, as in the reference's batched prefill.  Decode routes each
    slot alone at any capacity, so staggered single inserts equal each
    alone at the default capacity too."""
    m = Model(ARCHS[0])
    cfg = m.cfg
    if cf == "full":
        cfg = cfg.replace(capacity_factor=cfg.n_experts / cfg.top_k)
    prompts = _prompts(cfg, (9, 10, 11, 12), seed=5)

    def alone(p):
        eng = ServeEngine(cfg, m.params(), slots=4, seq_budget=BUDGET,
                          buckets=BUCKETS, device="cpu")
        eng.insert(Request(id=0, tokens=p, max_new_tokens=5))
        return _drain(eng)[0]

    solo = [alone(p) for p in prompts]
    eng = ServeEngine(cfg, m.params(), slots=4, seq_budget=BUDGET,
                      buckets=BUCKETS, device="cpu")
    if cf == "full":
        eng.insert_batch([Request(id=i, tokens=p, max_new_tokens=5)
                          for i, p in enumerate(prompts)])
    else:
        for i, p in enumerate(prompts):
            eng.insert(Request(id=i, tokens=p, max_new_tokens=5), float(i))
            eng.step(float(i))
    got = _drain(eng)
    assert [got[i] for i in range(4)] == solo
