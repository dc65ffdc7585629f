"""The port's simulator (`repro_torch.sim`) against the reference's
(`repro.sim`): the numpy-only copies (populations, samplers, the virtual
clock, both schedulers, the history) exactly equal on the same seeds, the
budget bound under hypothesis, and `SimRunner`'s plans, virtual clock and
byte ledger exactly equal to the reference runner's on the same fleet."""
import numpy as np
import pytest
import torch

from repro import sim as jsim
from repro.core.algorithms import DSFLAlgorithm as JAlgo
from repro.core.engine import FedEngine as JEngine
from repro.core.protocol import DSFLConfig as JConfig
from repro.models.smallnets import apply_tiny_mlp as j_apply
from repro.models.smallnets import init_tiny_mlp as j_init
from repro_torch import sim
from repro_torch.core.algorithms import DSFLAlgorithm
from repro_torch.core.engine import FedEngine
from repro_torch.core.protocol import DSFLConfig
from repro_torch.models.smallnets import apply_tiny_mlp, init_tiny_mlp

from test_torch_convert import numpy_task
from test_torch_convert import one_intra_op_thread  # noqa: F401

BOOKS = ("round", "t_round", "t_cum", "participants", "dropped",
         "mean_staleness", "up_bytes", "down_bytes", "cum_bytes")


def _pops(pkg, K):
    return {"lognormal": pkg.ClientPopulation.lognormal(
                3, K, compute_median=5.0, compute_sigma=0.8,
                uplink_median=2e4, uplink_sigma=1.0, availability=(0.6, 1.0)),
            "uniform": pkg.ClientPopulation.uniform(K, compute_time=2.0)}


def _same_plan(a, b):
    for f in ("mask", "staleness", "dropped", "ids", "dropped_ids"):
        if hasattr(b, f):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)
    assert (a.t_start, a.t_end) == (b.t_start, b.t_end)


@pytest.mark.parametrize("K", [7, 1000])
def test_populations_and_samplers_equal_the_reference(K):
    for kind, pop in _pops(sim, K).items():
        ref = _pops(jsim, K)[kind]
        for f in ("compute_time", "uplink", "downlink", "availability"):
            np.testing.assert_array_equal(getattr(pop, f), getattr(ref, f))
        np.testing.assert_array_equal(pop.latency(100.0, 1000.0),
                                      ref.latency(100.0, 1000.0))
        np.testing.assert_array_equal(pop.availability_cdf(),
                                      ref.availability_cdf())
        for name in sim.SAMPLERS:
            for seed in range(3):
                np.testing.assert_array_equal(
                    sim.SAMPLERS[name](np.random.default_rng(seed), pop, 0.3),
                    jsim.SAMPLERS[name](np.random.default_rng(seed), ref, 0.3))
                np.testing.assert_array_equal(
                    sim.COHORT_SAMPLERS[name](np.random.default_rng(seed),
                                              pop, 0.3),
                    jsim.COHORT_SAMPLERS[name](np.random.default_rng(seed),
                                               ref, 0.3))
        np.testing.assert_array_equal(
            sim.floyd_sample(np.random.default_rng(1), K, min(K, 5)),
            jsim.floyd_sample(np.random.default_rng(1), K, min(K, 5)))


@pytest.mark.parametrize("deadline", [None, 1.5])
def test_clock_equals_the_reference(deadline):
    rng = np.random.default_rng(0)
    lat = rng.uniform(0.5, 3.0, 9)
    sel = rng.random(9) < 0.5
    a, b = sim.VirtualClock(), jsim.VirtualClock()
    ta, tb = (c.charge_sync_round(sel, lat, deadline) for c in (a, b))
    for f in ("latency", "on_time", "dropped"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
    ca, cb = a.charge_cohort(lat[:4], deadline), b.charge_cohort(lat[:4],
                                                                 deadline)
    np.testing.assert_array_equal(ca.dropped, cb.dropped)
    assert (ta.duration, ca.duration, a.now) == (tb.duration, cb.duration,
                                                 b.now)
    with pytest.raises(ValueError):
        a.advance(-1.0)


SYNC = [dict(fraction=0.3, deadline=None, straggler="drop"),
        dict(fraction=0.3, deadline=8.0, straggler="admit",
             sampler="available"),
        dict(fraction=0.5, deadline=6.0, straggler="drop", sampler="uniform"),
        dict(fraction=1.0)]


@pytest.mark.parametrize("kw", SYNC)
@pytest.mark.parametrize("form", ["next_round", "next_cohort"])
def test_sync_scheduler_equals_the_reference(kw, form):
    pa, pb = _pops(sim, 40)["lognormal"], _pops(jsim, 40)["lognormal"]
    a, b = sim.SyncScheduler(pa, **kw), jsim.SyncScheduler(pb, **kw)
    assert (a.idealized, a.active_budget, a.plannable) == \
        (b.idealized, b.active_budget, b.plannable)
    for r in range(6):
        pl = [getattr(s, form)(np.random.default_rng([0, r]), 1600.0, 1600.0)
              for s in (a, b)]
        _same_plan(*pl)
        assert pl[0].n_participants <= a.active_budget
    assert a.state() == b.state()
    c = sim.SyncScheduler(pa, **kw)
    c.set_state(a.state())
    _same_plan(getattr(c, form)(np.random.default_rng(9), 1600.0, 1600.0),
               getattr(b, form)(np.random.default_rng(9), 1600.0, 1600.0))


@pytest.mark.parametrize("jitter", [0.0, 0.3])
@pytest.mark.parametrize("form", ["next_round", "next_cohort"])
def test_async_scheduler_equals_the_reference(jitter, form):
    pa, pb = _pops(sim, 12)["lognormal"], _pops(jsim, 12)["lognormal"]
    a = sim.AsyncBufferScheduler(pa, buffer_size=3, jitter_sigma=jitter)
    b = jsim.AsyncBufferScheduler(pb, buffer_size=3, jitter_sigma=jitter)
    assert (a.active_budget, a.plannable, a.idealized) == \
        (b.active_budget, b.plannable, b.idealized)
    for r in range(5):
        _same_plan(*(getattr(s, form)(np.random.default_rng([1, r]), 800.0,
                                      800.0) for s in (a, b)))
    assert a.state() == b.state()


def test_history_equals_the_reference():
    recs = [{"round": i + 1, "t_cum": 2.0 * i, "cum_bytes": 100 * i,
             "test_acc": 0.1 * i} for i in range(6)]
    a, b = sim.SimHistory(list(recs)), jsim.SimHistory(list(recs))
    assert a.time_to(0.3) == b.time_to(0.3) == 6.0
    assert a.bytes_to(0.45) == b.bytes_to(0.45) == 500
    assert a.time_to(9.0) is b.time_to(9.0) is None
    assert a.series("t_cum") == b.series("t_cum")
    assert a.to_json() == b.to_json()
    assert sim.SimHistory.from_json(a.to_json()).records == recs


def test_budget_bound_hypothesis():
    """Every sync plan, dense or cohort, stays within ``active_budget``
    and equals the reference's, for any fleet size, fraction, deadline and
    straggler rule."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @given(K=st.integers(1, 60), fraction=st.floats(0.01, 1.0),
           deadline=st.one_of(st.none(), st.floats(0.5, 20.0)),
           straggler=st.sampled_from(["drop", "admit"]),
           sampler=st.sampled_from(["uniform", "available"]),
           seed=st.integers(0, 2 ** 16))
    @settings(deadline=None, max_examples=40)
    def check(K, fraction, deadline, straggler, sampler, seed):
        kw = dict(fraction=fraction, deadline=deadline, straggler=straggler,
                  sampler=sampler)
        pop = sim.ClientPopulation.lognormal(seed, K, availability=(0.5, 1))
        ref = jsim.ClientPopulation.lognormal(seed, K, availability=(0.5, 1))
        for form in ("next_round", "next_cohort"):
            a = sim.SyncScheduler(pop, **kw)
            b = jsim.SyncScheduler(ref, **kw)
            for r in range(4):
                pa = getattr(a, form)(np.random.default_rng([seed, r]),
                                      5e4, 5e5)
                pb = getattr(b, form)(np.random.default_rng([seed, r]),
                                      5e4, 5e5)
                _same_plan(pa, pb)
                n = int(pa.mask.sum()) if form == "next_round" \
                    else pa.n_participants
                assert n <= a.active_budget

    check()


HP = dict(rounds=4, local_epochs=1, distill_epochs=1, batch_size=20,
          open_batch=40)


@pytest.mark.parametrize("chunk", [1, 2])
def test_sim_runner_books_equal_the_reference(chunk):
    """The same fleet and scheduler through both runners: measured leg
    bytes, every round's plan (participants, drops, staleness), the
    virtual clock and the byte ledger exactly equal."""
    K = 8
    ref_task, port_task = numpy_task(5, K, 40, 80, 40)
    kw = dict(fraction=0.25, deadline=8.0, straggler="admit",
              sampler="available")
    jeng = JEngine(JAlgo(j_apply, JConfig(**HP)))
    jr = jsim.SimRunner(jeng, jsim.SyncScheduler(_pops(jsim, K)["lognormal"],
                                                 **kw), seed=0)
    jr.run(jeng.init(j_init, ref_task), ref_task, rounds=4,
           chunk_rounds=chunk)
    eng = FedEngine(DSFLAlgorithm(apply_tiny_mlp, DSFLConfig(**HP),
                                  device="cpu"))
    pr = sim.SimRunner(eng, sim.SyncScheduler(_pops(sim, K)["lognormal"],
                                              **kw), seed=0)
    state = eng.init(lambda g: init_tiny_mlp(g, device="cpu"), port_task)
    pr.run(state, port_task, rounds=4, chunk_rounds=chunk)
    assert pr._leg_bytes == jr._leg_bytes
    assert [{k: r[k] for k in BOOKS} for r in pr.history] == \
        [{k: r[k] for k in BOOKS} for r in jr.history]
    assert pr.scheduler.state() == jr.scheduler.state()
    assert pr.cum_bytes == jr.cum_bytes
    assert eng.rounds_done == jeng.rounds_done == 4
    assert all(torch.isfinite(torch.tensor(r["update_loss"]))
               for r in pr.history)
