"""The port's serving path: its admission queue pinned exactly equal to the
reference's, its `ServeEngine` token-identical to the reference's lockstep
``launch.serve.serve`` on the same weights and prompts, and the engine's
own invariants, mirroring tests/test_serve.py: staggered requests decode as
each alone, ``insert_batch`` as single inserts, ``decode_chunk=d`` as d
single steps (mid-chunk finishers included), a swap lands at a chunk
boundary, and a prompt shorter than every bucket (bucket-1 prefill, tail
forced through decode) as an exact-length prefill.  As the reference's
tests do, the engine tests run on both families: ``arch`` ``"qwen"``
(qwen1.5-4b's ring-buffer KV cache, each slot at its own position) and
``"mamba"`` (mamba2-2.7b's O(1) SSM state).

Weights: the reference's ``init_lm`` at smoke size with the embedding
scaled by 0.1 for mamba and 0.03 for qwen (at unit scale the residual
stream is the input token's embedding and greedy decoding repeats the last
prompt token, which would make token identity a weak check; qwen's smoke
model still repeats it at 0.1).  Tokens must match exactly."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch.serve import serve as j_lockstep
from repro.models import transformer as JT
from repro.serve import AdmissionQueue as JQueue
from repro.serve import bucket_of as j_bucket_of
from repro_torch.configs import get_config
from repro_torch.launch.serve import serve as t_lockstep
from repro_torch.launch.serve import serve_continuous, steady_ms_per_step
from repro_torch.serve import (AdmissionQueue, Request, ServeEngine,
                               bucket_of)

from test_torch_convert import to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

CPU = "cpu"
ARCHS = {"qwen": "qwen1.5-4b", "mamba": "mamba2-2.7b"}
EMBED_SCALE = {"qwen": 0.03, "mamba": 0.1}
CFG = get_config("mamba2-2.7b").smoke()
BUCKETS = (8, 16)
BUDGET = 48


def _scaled_init(arch, jcfg, seed):
    p = jax.jit(lambda k: JT.init_lm(jcfg, k))(jax.random.PRNGKey(seed))
    p["embed"]["tok"] = p["embed"]["tok"] * EMBED_SCALE[arch]
    return p


def _model(arch):
    jcfg = jget_config(ARCHS[arch]).smoke()
    jp = _scaled_init(arch, jcfg, 0)
    return SimpleNamespace(arch=arch, jcfg=jcfg,
                           cfg=get_config(ARCHS[arch]).smoke(), jp=jp,
                           tp=to_port(jp))


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    """Each family's smoke model: reference config and weights, the port's
    config and the same weights."""
    return _model(request.param)


@pytest.fixture(scope="module")
def weights():
    """mamba2-2.7b's smoke model, for the tests that run one family."""
    return _model("mamba")


def _params(model):
    """A private copy of the port's weights (a swap writes in place)."""
    return {k: v.clone() for k, v in model.tp.items()}


def _prompts(lens, seed=3):
    g = np.random.default_rng(seed)
    return [tuple(int(x) for x in g.integers(0, CFG.vocab, size=S))
            for S in lens]


def _drain(engine, now=0.0, d=1):
    out = []
    while engine.n_active:
        now += 1.0
        engine.step(now, decode_chunk=d)
        out.extend(engine.pop_completed())
    return out


def _solo(params, tokens, max_new, buckets=BUCKETS, cfg=CFG):
    eng = ServeEngine(cfg, params, slots=1, seq_budget=BUDGET,
                      buckets=buckets, device=CPU)
    eng.insert(Request(id=0, tokens=tokens, max_new_tokens=max_new))
    (r,) = _drain(eng)
    return r.tokens


# ------------------------------------------------------------------- queue --
def test_bucket_of_matches_reference():
    for buckets in ((8, 16, 32), (1, 256, 1024, 2048), (5,)):
        for n in (1, 2, 5, 7, 8, 16, 20, 40, 100, 1030, 2048, 4000):
            assert bucket_of(n, buckets) == j_bucket_of(n, buckets)


@pytest.mark.parametrize("group", [False, True])
def test_admission_queue_pinned_to_reference(group):
    """The same random submit / admit / shed sequence through both queues:
    every returned request, shed response, counter and pending list equal."""
    g = np.random.default_rng(11 + group)
    kw = dict(buckets=(4, 8, 16), timeout=6.0, max_queue=9)
    qs = (AdmissionQueue(**kw), JQueue(**kw))
    now = 0.0
    for _ in range(200):
        now += float(g.exponential(0.7))
        op = g.integers(0, 3)
        if op < 2:
            toks = g.integers(0, 50, size=int(g.integers(1, 20))).tolist()
            max_new = int(g.integers(1, 8))
            outs = [[q.submit(toks, max_new, now)] for q in qs]
        else:
            free = int(g.integers(0, 4))
            outs = [q.admit(now, free, group=group) for q in qs]
        assert _fields(outs[0]) == _fields(outs[1])
        assert _fields(qs[0].shed) == _fields(qs[1].shed)
        assert _fields(qs[0].pending()) == _fields(qs[1].pending())
        assert (qs[0].n_submitted, qs[0].n_admitted, len(qs[0])) == (
            qs[1].n_submitted, qs[1].n_admitted, len(qs[1]))
    assert qs[0].shed and qs[0].n_admitted
    assert _fields(qs[0].shed_expired(now + 100)) == _fields(
        qs[1].shed_expired(now + 100))


def _fields(items):
    """Requests or Responses of either package as comparable tuples."""
    return [dataclasses.astuple(r) for r in items]


# ------------------------------------------------------- parity with JAX --
def test_engine_matches_reference_lockstep(model):
    """Bucket-exact prompts: the port's engine (one prefill per request,
    decode over the slot batch) and the port's own lockstep path give the
    reference lockstep path's greedy tokens exactly."""
    cfg = model.cfg
    B, S, gen = 3, 16, 8
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(B, S))
    base, _ = j_lockstep(model.jcfg, model.jp,
                         {"tokens": jnp.asarray(tokens, jnp.int32)},
                         gen, S + gen)
    base = np.asarray(base)
    assert len(set(base.ravel().tolist())) > gen      # not a repeated token

    params = _params(model)
    eng = ServeEngine(cfg, params, slots=B, seq_budget=S + gen,
                      buckets=(S,), device=CPU)
    for i in range(B):
        eng.insert(Request(id=i, tokens=tuple(int(t) for t in tokens[i]),
                           max_new_tokens=gen))
    got = {r.id: r.tokens for r in _drain(eng)}
    for i in range(B):
        assert got[i] == tuple(int(t) for t in base[i])

    toks, times = t_lockstep(cfg, params,
                             {"tokens": torch.from_numpy(tokens)}, gen,
                             S + gen)
    np.testing.assert_array_equal(toks.numpy(), base)
    assert steady_ms_per_step(times) > 0.0


# -------------------------------------------------------------- invariants --
def test_staggered_requests_match_each_alone(model):
    """Slots at different depths decode in one step: the queue admits the
    fourth request while the others are mid-generation."""
    params, cfg = _params(model), model.cfg
    prompts = _prompts(lens=(5, 12, 20, 16))
    max_new = 6
    solo = [_solo(params, p, max_new, cfg=cfg) for p in prompts]
    eng = ServeEngine(cfg, params, slots=3, seq_budget=BUDGET,
                      buckets=BUCKETS, device=CPU)
    q = AdmissionQueue(buckets=BUCKETS)
    for i, p in enumerate(prompts):            # staggered arrivals
        q.submit(p, max_new, now=float(i))
    got, now = {}, 0.0
    while len(got) < len(prompts):
        for req in q.admit(now, len(eng.free_slots())):
            eng.insert(req, now)
        for r in eng.step(now):
            got[r.id] = r.tokens
        now += 1.0
    assert [got[i] for i in range(len(prompts))] == solo
    assert eng.stats()["inserts"] == 4 and eng.n_prefill_shots == 4


def test_short_prompt_through_bucket_one_matches_exact_prefill(model):
    """Prompts of 1, 2 and 5 tokens (shorter than every bucket) prefill
    their first token and force the rest through decode; the tokens equal
    an engine whose bucket is the exact prompt length."""
    params, cfg = _params(model), model.cfg
    for p in _prompts(lens=(1, 2, 5), seed=4):
        eng = ServeEngine(cfg, params, slots=1, seq_budget=BUDGET,
                          buckets=BUCKETS, device=CPU)
        assert eng.buckets == (1, 8, 16) and eng.prefill_len(len(p)) == 1
        assert _solo(params, p, 4, cfg=cfg) == _solo(
            params, p, 4, buckets=(len(p),), cfg=cfg)


def test_insert_batch_matches_single_insert(model):
    params, cfg = _params(model), model.cfg
    prompts = _prompts(lens=(9, 12, 15), seed=6)
    max_new = 5
    solo = [_solo(params, p, max_new, cfg=cfg) for p in prompts]
    eng = ServeEngine(cfg, params, slots=4, seq_budget=BUDGET,
                      buckets=BUCKETS, device=CPU)
    shots, prefill = [], eng._prefill
    eng._prefill = lambda toks: shots.append(toks.shape) or prefill(toks)
    claimed = eng.insert_batch(
        [Request(id=i, tokens=p, max_new_tokens=max_new)
         for i, p in enumerate(prompts)])
    assert claimed == [0, 1, 2] and eng.n_prefill_shots == 1
    assert shots == [(3, 8)]                   # exactly the m rows, unpadded
    got = {r.id: r.tokens for r in _drain(eng)}
    assert [got[i] for i in range(3)] == solo

    mixed = [Request(id=0, tokens=tuple(range(1, 6)), max_new_tokens=2),
             Request(id=1, tokens=tuple(range(1, 13)), max_new_tokens=2)]
    with pytest.raises(ValueError, match="same-bucket"):
        eng.insert_batch(mixed)
    many = [Request(id=i, tokens=tuple(range(1, 10)), max_new_tokens=2)
            for i in range(5)]
    with pytest.raises(RuntimeError, match="free slots"):
        eng.insert_batch(many)
    with pytest.raises(ValueError, match="seq_budget"):
        eng.insert(Request(id=9, tokens=tuple(range(40)), max_new_tokens=9))
    assert eng.insert_batch([]) == []


def _drive_chunked(cfg, params, prompts, max_news, d, eos_id=None, dt=0.5):
    eng = ServeEngine(cfg, params, slots=len(prompts), seq_budget=BUDGET,
                      buckets=BUCKETS, eos_id=eos_id, device=CPU)
    for i, (p, m) in enumerate(zip(prompts, max_news)):
        eng.insert(Request(id=i, tokens=p, max_new_tokens=m), now=0.0)
    out, now = list(eng.pop_completed()), 0.0
    while eng.n_active:
        before = eng.n_steps
        now += dt
        out.extend(eng.step(now, decode_chunk=d, step_dt=dt))
        now += (eng.n_steps - before - 1) * dt
    return {r.id: r for r in out}, eng


def test_fused_decode_chunk_matches_single_step(model):
    """Tokens, timestamps and accounted steps of decode_chunk=d equal d
    single steps, with requests finishing mid-chunk (max tokens 2/6/9
    against d=4), prompt tails crossing chunk boundaries, and an EOS
    finisher."""
    params, cfg = _params(model), model.cfg
    prompts = _prompts(lens=(3, 12, 20), seed=5)
    max_news = (2, 6, 9)
    base, beng = _drive_chunked(cfg, params, prompts, max_news, d=1)
    eos = base[2].tokens[3]                  # req 2 stops at or before it
    base_eos, _ = _drive_chunked(cfg, params, prompts, max_news, d=1,
                                 eos_id=eos)
    assert len(base_eos[2].tokens) < 9
    for ref, eos_id in ((base, None), (base_eos, eos)):
        got, eng = _drive_chunked(cfg, params, prompts, max_news, d=4,
                                  eos_id=eos_id)
        if eos_id is None:
            assert eng.n_steps == beng.n_steps
            assert eng.n_dispatches < beng.n_dispatches
        for i in ref:
            assert got[i].tokens == ref[i].tokens
            assert got[i].first_token_at == ref[i].first_token_at
            assert got[i].finished_at == ref[i].finished_at


def test_hot_swap_lands_at_chunk_boundary(model):
    """A swap between fused chunks equals the same swap between single
    steps at the same token index, and stamps the same version."""
    cfg = model.cfg
    new = to_port(_scaled_init(model.arch, model.jcfg, 9))
    prompt = _prompts(lens=(8,), seed=8)[0]

    def run(d):
        eng = ServeEngine(cfg, _params(model), slots=1, seq_budget=BUDGET,
                          buckets=BUCKETS, device=CPU)
        eng.insert(Request(id=0, tokens=prompt, max_new_tokens=9))
        while eng.n_steps < 4:
            eng.step(decode_chunk=d)
        eng.swap_weights(new, version=5)
        while eng.n_active:
            eng.step(decode_chunk=d)
        (r,) = eng.pop_completed()
        return r, eng

    single, _ = run(1)
    chunked, eng = run(4)
    assert chunked.tokens == single.tokens
    assert chunked.weights_version == single.weights_version == 5
    for k, v in new.items():
        torch.testing.assert_close(eng.params[k], v, atol=0, rtol=0)
    # the swap changed the tokens
    assert _solo(_params(model), prompt, 9, cfg=cfg) != single.tokens

    bad = dict(new)
    leaf = {"qwen": "blocks/s0_mix/wq", "mamba": "blocks/s0_mix/w_z"}[
        model.arch]
    bad[leaf] = bad[leaf][..., :1]
    del bad["final_norm/scale"]
    with pytest.raises(ValueError, match="do not match") as err:
        eng.swap_weights(bad)
    assert f"{leaf}: shape" in str(err.value)
    assert "missing leaf final_norm/scale" in str(err.value)


def test_serve_continuous_paths_agree(weights):
    """The driver's continuous path, single inserts at d=1 and batched
    inserts at d=4, give the same tokens."""
    params = _params(weights)
    prompts = _prompts(lens=(16, 16, 9), seed=2)
    a, ta = serve_continuous(CFG, params, prompts, 5, 32)
    b, tb = serve_continuous(CFG, params, prompts, 5, 32, decode_chunk=4,
                             batch_insert=True)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert len(tb) < len(ta)


def test_serve_cli_on_cpu(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --smoke --device cpu`` in its
    three modes; without ``--device cpu`` it asks for the card."""
    from repro_torch.launch.serve import main
    base = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "9", "--gen", "3"]
    main(base)
    main(base + ["--decode-chunk", "2", "--batch-insert"])
    main(base + ["--lockstep"])
    out = capsys.readouterr().out
    assert out.count("[continuous] 2 requests, 6 tokens on cpu") == 2
    assert "[lockstep] generated (2, 3) tokens on cpu" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(base[:1])


def test_engine_defaults_to_the_card(weights, monkeypatch):
    params = _params(weights)
    with pytest.raises(ValueError, match="lie on meta"):
        ServeEngine(CFG, {k: v.to("meta") for k, v in params.items()},
                    device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(CFG, params)
