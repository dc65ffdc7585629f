"""The rest of `FedEngine` inside the port, on the CPU: fused chunks
(``chunk_rounds``), the pipelined schedule (``overlap``), ``start_round``
and checkpoints give the same bits as the per-round loop, for DS-FL (dense,
masked, sparse), FD and FedAvg, and through `SimRunner` (which also resumes
its virtual clock and byte ledger from the ``.sim.json`` sidecar).  Every
draw is keyed on (seed, round), so no generator state is carried."""
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import named_leaves
from repro_torch.core.algorithms import (DSFLAlgorithm, FDAlgorithm, FDConfig,
                                         FedAvgAlgorithm, FedAvgConfig)
from repro_torch.core.engine import FedEngine, make_eval_fn
from repro_torch.core.protocol import DSFLConfig
from repro_torch.data.pipeline import build_image_task
from repro_torch.models.smallnets import apply_tiny_mlp, init_tiny_mlp
from repro_torch.obs import MetricsRegistry
from repro_torch.obs import trace as obs
from repro_torch.sim import (AsyncBufferScheduler, ClientPopulation,
                             SimRunner, SyncScheduler)

from test_torch_convert import one_intra_op_thread  # noqa: F401

K, ROUNDS = 6, 4
HP = dict(rounds=ROUNDS, local_epochs=1, batch_size=20)
MASK = torch.tensor([[1, 0, 1, 0, 1, 0], [0, 1, 1, 0, 0, 1],
                     [1, 1, 0, 0, 0, 1], [0, 0, 1, 1, 1, 0]],
                    dtype=torch.float32)


def _init(g):
    return init_tiny_mlp(g, device="cpu")


@pytest.fixture(scope="module")
def task():
    return build_image_task(3, K, 40 * K, 80, 40, device="cpu")


def _algo(kind, aggregation="era"):
    if kind == "dsfl":
        return DSFLAlgorithm(apply_tiny_mlp, DSFLConfig(
            **HP, distill_epochs=1, open_batch=40, aggregation=aggregation),
            use_kernel=True, device="cpu")
    if kind == "fd":
        return FDAlgorithm(apply_tiny_mlp, FDConfig(**HP, gamma=0.1),
                           device="cpu")
    return FedAvgAlgorithm(apply_tiny_mlp, FedAvgConfig(**HP), device="cpu")


def _engine(algo, task, eval_fn=True):
    return FedEngine(algo, make_eval_fn(apply_tiny_mlp, task.x_test,
                                        task.y_test) if eval_fn else None)


def _assert_same(a, b):
    la, lb = named_leaves(a), named_leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (n, x), (_, y) in zip(la, lb):
        assert torch.equal(x, y), n


PLANS = {"dense": {}, "masked": {"ctx_plan": {"mask": MASK}},
         "sparse": {"ctx_plan": {"mask": MASK}, "active_budget": 3}}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("kind", ["dsfl", "fd", "fedavg"])
def test_chunked_equals_loop_bitwise(task, kind, plan):
    """Chunks of 2 and of 4 (and, for DS-FL, the pipelined schedule) give
    the loop's leaves, history and last metrics bit for bit."""
    algo = _algo(kind)
    start = FedEngine(algo).init(_init, task)
    runs = {}
    schedules = {"loop": {}, "chunk2": dict(chunk_rounds=2, log_every=2),
                 "chunk4": dict(chunk_rounds=4, log_every=4)}
    if kind == "dsfl":
        schedules["overlap"] = dict(chunk_rounds=4, log_every=4, overlap=True)
    for name, kw in schedules.items():
        eng = _engine(algo, task)
        kw = {"log_every": 2, **kw}
        runs[name] = (eng.run(start, task, **PLANS[plan], **kw), eng)
    (want, weng) = runs["loop"]
    for name, (state, eng) in runs.items():
        _assert_same(state, want)
        hist = [r for r in weng.history if r["round"] % eng.history[0][
            "round"] == 0]
        assert eng.history == hist, name
        for k, v in weng.last_metrics.items():
            assert torch.equal(eng.last_metrics[k], v), (name, k)
        assert eng.rounds_done == ROUNDS


def test_chunks_snap_to_log_every_and_report_once(task):
    """With ``eval_fn``, chunks end on log boundaries (a warning says the
    fusion is cut); ``on_chunk`` sees each chunk's end; one
    ``engine.chunk`` span a chunk."""
    algo = _algo("dsfl")
    seen = []
    eng = FedEngine(algo, make_eval_fn(apply_tiny_mlp, task.x_test,
                                       task.y_test),
                    on_chunk=lambda n, s: seen.append(n))
    start = eng.init(_init, task)
    reg = MetricsRegistry()
    prev = obs.install_registry(reg)
    try:
        with pytest.warns(UserWarning, match="snaps every chunk"):
            eng.run(start, task, rounds=5, chunk_rounds=4, log_every=2)
    finally:
        obs.install_registry(prev)
    assert seen == [2, 4, 5]
    assert [r["round"] for r in eng.history] == [2, 4]
    assert reg.snapshot()["engine.chunks"] == 3
    assert reg.snapshot()["engine.rounds"] == 5


def test_start_round_and_split_runs(task):
    """Two runs of 2 rounds continue the key stream of one run of 4;
    ``start_round`` picks the round a run's draws are keyed on."""
    algo = _algo("dsfl")
    start = FedEngine(algo).init(_init, task)
    full = FedEngine(algo).run(start, task, ctx_plan={"mask": MASK},
                               active_budget=3)
    eng = FedEngine(algo)
    mid = eng.run(start, task, rounds=2, ctx_plan={"mask": MASK[:2]},
                  active_budget=3, chunk_rounds=2)
    end = eng.run(mid, task, rounds=2, ctx_plan={"mask": MASK[2:]},
                  active_budget=3)
    _assert_same(end, full)
    again = FedEngine(algo).run(mid, task, rounds=2, start_round=2,
                                ctx_plan={"mask": MASK[2:]}, active_budget=3)
    _assert_same(again, full)
    other = FedEngine(algo).run(mid, task, rounds=2, start_round=0,
                                ctx_plan={"mask": MASK[2:]}, active_budget=3)
    assert not all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(named_leaves(other), named_leaves(full)))


@pytest.mark.parametrize("kind", ["dsfl", "fd", "fedavg"])
def test_save_load_run_equals_uninterrupted(task, kind, tmp_path):
    algo = _algo(kind)
    start = FedEngine(algo).init(_init, task)
    full_eng = _engine(algo, task)
    full = full_eng.run(start, task, ctx_plan={"mask": MASK},
                        active_budget=3, chunk_rounds=2, log_every=2)
    eng = _engine(algo, task)
    half = eng.run(start, task, rounds=2, ctx_plan={"mask": MASK[:2]},
                   active_budget=3, chunk_rounds=2, log_every=2)
    path = str(tmp_path / "ckpt")
    eng.save_state(path, half)
    eng2 = _engine(algo, task)
    loaded = eng2.load_state(path, start)
    _assert_same(loaded, half)
    assert eng2.rounds_done == 2 and eng2.history == eng.history
    end = eng2.run(loaded, task, rounds=2, ctx_plan={"mask": MASK[2:]},
                   active_budget=3, chunk_rounds=2, log_every=2)
    _assert_same(end, full)
    assert eng2.history == full_eng.history


def test_overlap_needs_round_halves_and_warns_on_the_loop(task):
    with pytest.raises(ValueError, match="round_start"):
        FedEngine(_algo("fedavg")).run(None, task, overlap=True)
    algo = _algo("dsfl")
    start = FedEngine(algo).init(_init, task)
    with pytest.warns(UserWarning, match="only pipelines the chunked path"):
        got = FedEngine(algo).run(start, task, rounds=1, overlap=True)
    _assert_same(got, FedEngine(algo).run(start, task, rounds=1))


def _sync_runner(algo, task):
    pop = ClientPopulation.lognormal(2, K, compute_median=5.0,
                                     uplink_median=2e4,
                                     availability=(0.6, 1.0))
    sched = SyncScheduler(pop, fraction=0.34, deadline=12.0,
                          straggler="admit", sampler="available")
    return SimRunner(_engine(algo, task), sched, seed=1)


def _books(runner):
    return ([{k: v for k, v in r.items()} for r in runner.history],
            runner.scheduler.state(), runner.cum_bytes)


@pytest.mark.parametrize("aggregation", ["sa", "weighted_era"])
def test_sim_runner_schedules_and_resume_bitwise(task, aggregation,
                                                 tmp_path):
    """`SimRunner` fused (chunks of 2), per round, pipelined and resumed
    from a checkpoint after its first chunk: the same leaves, history,
    scheduler books and bytes, bit for bit."""
    algo = _algo("dsfl", aggregation)
    start = FedEngine(algo).init(_init, task)
    out = {}
    for name, kw in (("fused", dict(chunk_rounds=2)),
                     ("loop", dict(chunk_rounds=1)),
                     ("overlap", dict(chunk_rounds=2, overlap=True))):
        r = _sync_runner(algo, task)
        out[name] = (r.run(start, task, rounds=ROUNDS, log_every=2, **kw), r)
    want, wr = out["fused"]
    assert wr.history.records[-1]["participants"] >= 1
    for name, (state, r) in out.items():
        _assert_same(state, want)
        assert _books(r) == _books(wr), name
    r1 = _sync_runner(algo, task)
    half = r1.run(start, task, rounds=2, chunk_rounds=2, log_every=2)
    path = str(tmp_path / "sim")
    r1.save_state(path, half)
    r2 = _sync_runner(algo, task)
    loaded = r2.load_state(path, start)
    assert r2.cum_bytes == r1.cum_bytes
    assert r2.scheduler.state() == r1.scheduler.state()
    end = r2.run(loaded, task, rounds=2, chunk_rounds=2, log_every=2)
    _assert_same(end, want)
    assert _books(r2) == _books(wr)


def test_async_sim_runner_takes_the_loop_and_resumes(task, tmp_path):
    """The buffered-async scheduler cannot be planned ahead: `SimRunner`
    runs it a round at a time through ``on_ctx`` (``chunk_rounds`` is
    ignored) and resumes it bitwise."""
    algo = _algo("dsfl")
    start = FedEngine(algo).init(_init, task)

    def runner():
        lat = np.array([1.0, 3.5, 1.0, 2.0, 1.5, 2.5])
        inf = np.full_like(lat, np.inf)
        pop = ClientPopulation(lat, inf, inf, np.ones_like(lat))
        return SimRunner(_engine(algo, task),
                         AsyncBufferScheduler(pop, buffer_size=2), seed=0)

    r = runner()
    want = r.run(start, task, rounds=ROUNDS, chunk_rounds=2)
    assert [h["participants"] for h in r.history] == [2] * ROUNDS
    r1 = runner()
    half = r1.run(start, task, rounds=2)
    r1.save_state(str(tmp_path / "a"), half)
    r2 = runner()
    end = r2.run(r2.load_state(str(tmp_path / "a"), start), task, rounds=2)
    _assert_same(end, want)
    assert _books(r2) == _books(r)
