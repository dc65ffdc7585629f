"""The cohort plane inside the port (`repro_torch.core.cohort`,
`repro_torch.sim.CohortRunner`, the data providers), on the CPU.

The pin: `CohortRunner` over an `ArrayProvider` (host store keyed by global
id, slabs of S lanes, ``BatchCtx.cohort``) equals `SimRunner`'s dense
rounds fed the same plans, bit for bit: the server, every stored client
row, the history and the books, for DS-FL (SA, ERA, weighted ERA), FD,
FedAvg and the buffered-async scheduler.  Keyed draws give a client the
same rows in any slab, and every cross-client sum runs lane after lane, so
the slab's exact-zero lanes change nothing.  The store's padding and
checkpoint, the slab planners (held to the reference's) and the synthetic
provider's per-id rows are pinned beside it."""
import numpy as np
import pytest
import torch

from repro.core.cohort import build_slab as j_build_slab
from repro.core.cohort import slab_ctx_plan as j_slab_ctx_plan
from repro_torch.checkpoint import named_leaves
from repro_torch.core.algorithms import (DSFLAlgorithm, FDAlgorithm, FDConfig,
                                         FedAvgAlgorithm, FedAvgConfig)
from repro_torch.core.cohort import ClientStore, build_slab, slab_ctx_plan
from repro_torch.core.engine import FedEngine, make_eval_fn
from repro_torch.core.protocol import DSFLConfig
from repro_torch.data.pipeline import (ArrayProvider, SyntheticProvider,
                                       build_image_task)
from repro_torch.models.smallnets import apply_tiny_mlp, init_tiny_mlp
from repro_torch.sim import (AsyncBufferScheduler, ClientPopulation,
                             CohortRunner, RoundPlan, SimRunner,
                             SyncScheduler, VirtualClock)

from test_torch_convert import one_intra_op_thread  # noqa: F401

K, ROUNDS = 8, 4
CPU = "cpu"
HP = dict(rounds=ROUNDS, local_epochs=1, batch_size=20)


def _init(g):
    return init_tiny_mlp(g, device="cpu")


@pytest.fixture(scope="module")
def task():
    return build_image_task(4, K, 40 * K, 80, 40, device="cpu")


class Recording(SyncScheduler):
    """A sync scheduler that keeps the cohort plans it hands out."""

    def next_cohort(self, rng, up_bytes, down_bytes):
        plan = super().next_cohort(rng, up_bytes, down_bytes)
        self.__dict__.setdefault("cohorts", []).append(plan)
        return plan


class Replay:
    """Hands `SimRunner` the dense form of recorded cohort plans (cohort
    draws differ from ``next_round``'s, so both runners get the same
    realized rounds this way)."""
    plannable, idealized = True, False

    def __init__(self, cohorts, population, active_budget):
        self.cohorts, self.population = list(cohorts), population
        self.active_budget, self.clock = active_budget, VirtualClock()

    def next_round(self, rng, up_bytes, down_bytes):
        p, n = self.cohorts.pop(0), self.population.n_clients
        dropped = np.zeros(n, bool)
        dropped[p.dropped_ids] = True
        self.clock.now = p.t_end
        return RoundPlan(p.dense_mask(n), p.dense_staleness(n), p.t_start,
                         p.t_end, dropped)

    def state(self):
        return {"now": self.clock.now}


def _pop():
    return ClientPopulation.lognormal(1, K, compute_median=2.0,
                                      uplink_median=2e4,
                                      availability=(0.6, 1.0))


def _algo(kind, aggregation="era"):
    if kind == "dsfl":
        return DSFLAlgorithm(apply_tiny_mlp, DSFLConfig(
            **HP, distill_epochs=1, open_batch=40, aggregation=aggregation),
            use_kernel=True, device="cpu")
    if kind == "fd":
        return FDAlgorithm(apply_tiny_mlp, FDConfig(**HP, gamma=0.1),
                           device="cpu")
    return FedAvgAlgorithm(apply_tiny_mlp, FedAvgConfig(**HP), device="cpu")


def _engine(algo, task):
    return FedEngine(algo, make_eval_fn(apply_tiny_mlp, task.x_test,
                                        task.y_test))


def _cohort_run(algo, task, sched, chunk):
    store = (None if isinstance(algo, FedAvgAlgorithm) else
             ClientStore(lambda ids: algo.init_cohort(0, _init, ids, K),
                         device=CPU))
    start = (algo.init(0, _init, None) if store is None
             else algo.init_server(0, _init))
    runner = CohortRunner(_engine(algo, task), sched, ArrayProvider(task),
                          store=store)
    state = runner.run(start, rounds=ROUNDS, chunk_rounds=chunk,
                       log_every=chunk)
    return runner, state


def _assert_equal_to_dense(runner, state, dense_runner, dense,
                           skip=("resident_bytes",)):
    for (n, a), (_, b) in zip(named_leaves(state.server),
                              named_leaves(dense.server)):
        assert torch.equal(a, b), n
    if runner.store is not None:
        names = named_leaves(dense.clients)
        for cid in runner.store.ids():
            for (n, v), row in zip(names, runner.store._rows[int(cid)]):
                assert torch.equal(row, v[int(cid)]), (int(cid), n)
    strip = lambda recs: [{k: v for k, v in r.items() if k not in skip}
                          for r in recs]
    assert strip(runner.history) == strip(dense_runner.history)
    assert runner.cum_bytes == dense_runner.cum_bytes


SYNC = {"admit": dict(fraction=0.5, deadline=3.0, straggler="admit"),
        "drop": dict(fraction=0.34, deadline=None, straggler="drop",
                     sampler="available")}


@pytest.mark.parametrize("budget", ["auto", None])
@pytest.mark.parametrize("kind,aggregation,sched", [
    ("dsfl", "sa", "admit"), ("dsfl", "era", "admit"),
    ("dsfl", "weighted_era", "drop"), ("fd", "era", "admit"),
    ("fedavg", "era", "drop")])
def test_cohort_runner_equals_dense_rounds_bitwise(task, kind, aggregation,
                                                   sched, budget):
    """Chunks of 2 rounds (slabs of 2 x budget lanes, sparse inside the
    slab) against `SimRunner` on the same plans, its rounds sparse
    (``"auto"``) or dense masked (None)."""
    algo = _algo(kind, aggregation)
    rec = Recording(_pop(), **SYNC[sched])
    runner, state = _cohort_run(algo, task, rec, chunk=2)
    assert runner.peak_slab_bytes > 0 or runner.store is None
    dense_runner = SimRunner(_engine(algo, task),
                             Replay(rec.cohorts, _pop(), rec.active_budget))
    dense = dense_runner.run(FedEngine(algo).init(_init, task), task,
                             rounds=ROUNDS, chunk_rounds=2, log_every=2,
                             active_budget=budget)
    # FD scores the mean client model: on a slab, the slab's mean
    skip = ("resident_bytes",) + (("test_acc",) if kind == "fd" else ())
    _assert_equal_to_dense(runner, state, dense_runner, dense, skip)


def test_async_cohort_runner_equals_sim_runner(task):
    """Buffered-async cohorts (one round a chunk) against `SimRunner`'s
    async rounds: at jitter 0 both realize the same rounds."""
    algo = _algo("dsfl")

    def pop():
        lat = np.array([1.0, 3.5, 1.0, 2.0, 1.5, 2.5, 3.0, 1.2])
        inf = np.full_like(lat, np.inf)
        return ClientPopulation(lat, inf, inf, np.ones_like(lat))

    runner, state = _cohort_run(algo, task,
                                AsyncBufferScheduler(pop(), buffer_size=2),
                                chunk=1)
    dense_runner = SimRunner(_engine(algo, task),
                             AsyncBufferScheduler(pop(), buffer_size=2))
    dense = dense_runner.run(FedEngine(algo).init(_init, task), task,
                             rounds=ROUNDS)
    _assert_equal_to_dense(runner, state, dense_runner, dense)


def test_store_pads_inits_and_never_writes_pad_lanes(tmp_path):
    """Missing ids are made in one call padded to the gather size; a
    scatter writes real lanes only; the store's file round-trips."""
    algo = _algo("dsfl")
    calls = []

    def init_fn(ids):
        calls.append(np.asarray(ids).tolist())
        return algo.init_cohort(0, _init, ids, K)

    store = ClientStore(init_fn, device=CPU)
    slab_ids = np.array([2, 5, 2, 2])          # lanes 2, 3 pad with id 2
    slab = store.gather(slab_ids)
    assert calls == [[2, 5, 2, 2]] and len(store) == 2
    fresh = algo.init_cohort(0, _init, np.array([2, 5]), K)
    for (n, a), (_, b) in zip(named_leaves(slab), named_leaves(fresh)):
        assert torch.equal(a[:2], b) and torch.equal(a[2], b[0]), n
    moved = type(slab)(**{f: {k: v + i for i, (k, v) in
                              enumerate(getattr(slab, f).items())}
                          for f in ("params", "model_state", "opt_update",
                                    "opt_distill")})
    poisoned = type(slab)(**{f: {k: torch.cat([v[:2], v[2:] * 0 - 7])
                                 for k, v in getattr(moved, f).items()}
                             for f in ("params", "model_state", "opt_update",
                                       "opt_distill")})
    store.scatter(slab_ids, poisoned, n_real=2)
    again = store.gather(np.array([5, 2]))
    assert calls == [[2, 5, 2, 2]]             # nothing made twice
    for (n, a), (_, b) in zip(named_leaves(again), named_leaves(moved)):
        assert torch.equal(a[0], b[1]) and torch.equal(a[1], b[0]), n
    row_bytes = sum(v[0].numel() * 4 for _, v in named_leaves(fresh))
    assert store.resident_bytes() == 2 * row_bytes
    store.save(str(tmp_path / "store"))
    other = ClientStore(init_fn, device=CPU)
    other.load(str(tmp_path / "store"))
    assert other.ids().tolist() == [2, 5]
    for (n, a), (_, b) in zip(named_leaves(other.gather(np.array([2, 5]))),
                              named_leaves(store.gather(np.array([2, 5])))):
        assert torch.equal(a, b), n
    empty = ClientStore(init_fn, device=CPU)
    empty.save(str(tmp_path / "none"))
    empty.load(str(tmp_path / "none"))
    assert len(empty) == 0


def test_store_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """A store made without ``device=`` gathers onto the card, as every
    entry point does; without a card it raises instead of quietly keeping
    its slabs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClientStore(lambda ids: None)
    assert ClientStore(lambda ids: None, device=CPU).device.type == "cpu"


@pytest.mark.parametrize("seed", range(4))
def test_slab_planning_equals_the_reference(seed):
    rng = np.random.default_rng(seed)

    class Plan:
        def __init__(self, ids):
            self.ids = np.sort(ids)
            self.staleness = rng.integers(0, 3, ids.size)

    plans = [Plan(rng.choice(50, int(rng.integers(1, 6)), replace=False))
             for _ in range(3)]
    ids, n = build_slab([p.ids for p in plans], 15)
    jids, jn = j_build_slab([p.ids for p in plans], 15)
    np.testing.assert_array_equal(ids, jids)
    assert n == jn
    ours, ref = slab_ctx_plan(plans, ids, n), j_slab_ctx_plan(plans, jids, jn)
    for k in ("mask", "stale"):
        np.testing.assert_array_equal(ours[k], ref[k])
    assert not ours["mask"][:, n:].any()
    with pytest.raises(ValueError, match="slab_size"):
        build_slab([p.ids for p in plans], n - 1)


def test_synthetic_rows_do_not_depend_on_order_or_company():
    prov = SyntheticProvider(0, 1_000_000, n_per_client=6, n_open=10,
                             n_test=5, device="cpu")
    a = prov.slab(np.array([3, 999_999, 17]))
    b = prov.slab(np.array([17, 3]))
    assert torch.equal(a.x_clients[0], b.x_clients[1])
    assert torch.equal(a.y_clients[2], b.y_clients[0])
    assert not torch.equal(a.x_clients[0], a.x_clients[2])
    assert tuple(a.x_clients.shape) == (3, 6, 16, 16, 1)
    again = SyntheticProvider(0, 1_000_000, n_per_client=6, n_open=10,
                              n_test=5, device="cpu")
    assert torch.equal(again.open_x, prov.open_x)
    assert torch.equal(again.slab(np.array([999_999])).x_clients[0],
                       a.x_clients[1])
    other = SyntheticProvider(1, 1_000_000, n_per_client=6, n_open=10,
                              device="cpu")
    assert not torch.equal(other.slab(np.array([3])).x_clients[0],
                           a.x_clients[0])
    assert other.x_test is None


def _lanes_with_zeros(x, at):
    """x (K, ...) with exact-zero lanes inserted before the lanes ``at``."""
    rows = []
    for k in range(x.shape[0]):
        rows += [torch.zeros_like(x[k])] * at.count(k) + [x[k]]
    return torch.stack(rows + [torch.zeros_like(x[0])])


@pytest.mark.parametrize("cols", [1, 2, 1000])
def test_lane_sum_is_sequential_in_double_on_the_cpu(cols):
    """`lanes.lane_sum` on the CPU equals a loop over the lanes that
    accumulates in double, bitwise, with values spread over 12 decades (so
    any other order shows); exact-zero lanes anywhere change no bit.  The
    cohort plane's bitwise equality with the dense rounds rests on this
    order, which is torch's cumsum and not a documented contract."""
    from repro_torch.lanes import lane_sum
    rng = np.random.default_rng(cols)
    x = torch.from_numpy((rng.standard_normal((37, cols))
                          * np.logspace(-6, 6, 37)[:, None]).astype(np.float32))
    acc = torch.zeros(cols, dtype=torch.float64)
    for k in range(x.shape[0]):
        acc = acc + x[k].double()
    assert torch.equal(lane_sum(x), acc.float())
    assert torch.equal(lane_sum(_lanes_with_zeros(x, [0, 0, 5, 36])),
                       lane_sum(x))
