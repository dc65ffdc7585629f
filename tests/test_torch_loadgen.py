"""The port's load generator (`repro_torch.serve.loadgen`) and exact
percentiles (`repro_torch.obs.metrics`) pinned to the reference's: the
arrivals equal exactly for several specs, the percentiles equal, and a
whole `run_load` on the smoke-size qwen1.5-4b through the port's engine
gives the reference's virtual summary key by key (its ``compiles``, the
wall seconds and the wall rate aside), response by response, on the
default path, the fused decode chunk and the batched insert.  Across those
paths every request gets the same tokens; the fused chunk admits requests
only between chunks, so its virtual latencies differ, in both packages."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro.obs import metrics as jmetrics
from repro.serve import AdmissionQueue as JQueue
from repro.serve import LoadSpec as JSpec
from repro.serve import ServeEngine as JEngine
from repro.serve import draw_arrivals as j_draw
from repro.serve import run_load as j_run_load
from repro_torch.configs import get_config
from repro_torch.obs import metrics
from repro_torch.serve import (AdmissionQueue, LoadSpec, ServeEngine,
                               draw_arrivals, run_load)

from test_torch_convert import to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

QWEN = get_config("qwen1.5-4b").smoke()
BUCKETS, BUDGET = (8, 16), 48
# tests/test_serve.py's load-generator spec
SPEC = dict(n_requests=12, rate=6.0, prompt_len=(3, 30), max_new=(2, 6),
            vocab=QWEN.vocab, seed=11)
WALL = {"wall_s", "throughput_tok_per_wall_s"}


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_config("qwen1.5-4b").smoke()
    jp = jax.jit(lambda k: JT.init_lm(jcfg, k))(jax.random.PRNGKey(0))
    jp["embed"]["tok"] = jp["embed"]["tok"] * 0.03
    return jcfg, jp, to_port(jp)


def _run(make_engine, make_queue, spec, run, **kw):
    eng = make_engine()
    q = make_queue(buckets=BUCKETS, timeout=60.0, max_queue=32)
    return run(eng, q, spec, **kw)


def _port(weights, **kw):
    _, _, tp = weights
    rep = _run(lambda: ServeEngine(QWEN, {k: v.clone() for k, v in
                                          tp.items()}, slots=3,
                                   seq_budget=BUDGET, buckets=BUCKETS,
                                   device="cpu"),
               AdmissionQueue, LoadSpec(**SPEC), run_load, **kw)
    assert "compiles" not in rep
    return rep


def _virtual(rep):
    """The summary without its wall-clock numbers, responses as tuples."""
    out = {k: v for k, v in rep.items() if k not in WALL | {"compiles"}}
    out["responses"] = [dataclasses.astuple(r) for r in rep["responses"]]
    return out


@pytest.mark.parametrize("spec", [
    dict(), dict(n_requests=12, rate=6.0, prompt_len=(3, 30), max_new=(2, 6),
                 vocab=512, seed=11),
    dict(n_requests=32, rate=4.0, prompt_len=(4, 48), max_new=(4, 16),
         vocab=151936, seed=0),
    dict(n_requests=100, rate=0.5, prompt_len=(1, 1), max_new=(1, 64),
         vocab=2, seed=7)])
def test_draw_arrivals_matches_reference(spec):
    got, want = draw_arrivals(LoadSpec(**spec)), j_draw(JSpec(**spec))
    assert got == want
    assert dataclasses.asdict(LoadSpec(**spec)) == dataclasses.asdict(
        JSpec(**spec))


def test_percentiles_match_reference():
    g = np.random.default_rng(0)
    for xs in ([], [3.0], [1.0, 2.0], g.exponential(size=101).tolist(),
               g.standard_normal(1000).tolist()):
        for q in (0, 1, 50, 90, 99, 99.9, 100):
            for empty in (-1.0, None):
                assert metrics.percentile(xs, q, empty) == \
                    jmetrics.percentile(xs, q, empty)
        assert metrics.percentiles(xs) == jmetrics.percentiles(xs)
        assert metrics.percentiles(xs, (10, 99.5), None) == \
            jmetrics.percentiles(xs, (10, 99.5), None)


PATHS = [dict(), dict(decode_chunk=4), dict(batch_insert=True),
         dict(decode_chunk=8, batch_insert=True)]


@pytest.mark.parametrize("kw", PATHS)
def test_run_load_matches_reference(weights, kw):
    jcfg, jp, _ = weights
    want = _run(lambda: JEngine(jcfg, jp, slots=3, seq_budget=BUDGET,
                                buckets=BUCKETS),
                JQueue, JSpec(**SPEC), j_run_load, **kw)
    got = _port(weights, **kw)
    assert set(got) == set(want) - {"compiles"}
    assert _virtual(got) == _virtual(want)
    assert got["completed"] + got["shed"] == SPEC["n_requests"]
    assert got["tokens"] > 0 and got["latency_p99_s"] >= got["latency_p50_s"]
    assert got["throughput_tok_per_wall_s"] > 0


@pytest.mark.parametrize("kw", PATHS[1:])
def test_fused_and_batched_paths_match_defaults(weights, kw):
    """Token-identical paths: every request gets the defaults' tokens, and
    the same requests complete and shed."""
    base, got = _port(weights), _port(weights, **kw)
    tokens = lambda rep: {r.id: (r.tokens, r.shed) for r in rep["responses"]}
    assert tokens(got) == tokens(base)
    for k in ("completed", "shed", "tokens", "n_submitted", "n_admitted"):
        assert got[k] == base[k], k
    if "decode_chunk" in kw:
        assert got["decode_dispatches"] < base["decode_dispatches"]
    else:
        assert _virtual(got) == _virtual(base)
