"""Round schedulers: who participates, how stale they are, what time it is.

Both schedulers emit a `RoundPlan` per aggregation round — a participation
mask, per-client staleness, and the virtual-time window — which `SimRunner`
injects into the round as ``BatchCtx.mask`` / ``.stale`` (the
aggregation then gives absent clients exactly zero weight and decays stale
contributions by ``staleness_decay**stale``; see `core.aggregation`).

* `SyncScheduler` — FedAvg-style deadline rounds: sample a cohort, wait for
  the slowest on-time member (or the straggler deadline).  Late clients are
  either dropped or admitted into the *next* round with staleness 1+.
* `AsyncBufferScheduler` — FedBuff-style: every client trains continuously
  at its own pace; the server aggregates whenever ``buffer_size`` uploads
  have arrived.  A client that last synced at aggregation j and arrives at
  aggregation j' contributes with staleness j' - j - 1.

State (virtual clock, pending/arrival arrays, counters) is exposed via
``state()``/``set_state()`` dicts so a checkpointed simulation resumes on
the same wallclock axis.

A copy of ``repro/sim/scheduler.py`` (numpy only), held exactly equal to it
on the same seeds by ``tests/test_torch_sim.py``.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field

import numpy as np

from ..obs import trace as obs
from .clients import COHORT_SAMPLERS, SAMPLERS, ClientPopulation
from .clock import VirtualClock


def _publish_plan(n_participants: int, n_dropped: int, t_end: float) -> None:
    """Scheduler-side metrics: cohort sizes, straggler drops, and the
    virtual clock, published into the installed registry (no-op without
    one — a single global read per planned round)."""
    reg = obs.current_registry()
    if reg is not None:
        reg.counter("sched.rounds_planned").inc()
        reg.counter("sched.dropped").inc(n_dropped)
        reg.histogram("sched.participants",
                      bounds=tuple(float(2 ** i)
                                   for i in range(21))).observe(n_participants)
        reg.gauge("sched.virtual_time_s").set(t_end)


@dataclass(frozen=True)
class RoundPlan:
    """One aggregation round's participation and timing."""
    mask: np.ndarray           # (K,) bool — whose upload enters aggregation
    staleness: np.ndarray      # (K,) int — label lag of each contribution
    t_start: float
    t_end: float
    dropped: np.ndarray        # (K,) bool — selected but cut by the deadline

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    @property
    def n_participants(self) -> int:
        return int(self.mask.sum())


@dataclass(frozen=True)
class CohortPlan:
    """`RoundPlan`'s O(m) form: sorted global ids instead of (K,) arrays —
    the only participation record the cohort-resident path ever holds, so
    planning a round costs O(m log K) regardless of fleet size.  Densify
    with ``dense_mask`` only in small-K parity tests."""
    ids: np.ndarray            # (m,) int64 sorted — whose upload aggregates
    staleness: np.ndarray      # (m,) int64 aligned with ``ids``
    t_start: float
    t_end: float
    dropped_ids: np.ndarray    # (d,) int64 — selected but cut by the deadline

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start

    @property
    def n_participants(self) -> int:
        return int(self.ids.size)

    def dense_mask(self, K: int) -> np.ndarray:
        mask = np.zeros(K, bool)
        mask[self.ids] = True
        return mask

    def dense_staleness(self, K: int) -> np.ndarray:
        stale = np.zeros(K, np.int64)
        stale[self.ids] = self.staleness
        return stale


@dataclass
class SyncScheduler:
    """Synchronous deadline rounds over a `ClientPopulation`.

    ``fraction`` of the K clients is sampled each round (``sampler`` is
    "uniform" or the availability-weighted "available"); ``deadline`` (in
    virtual seconds) cuts stragglers, which are dropped (``straggler=
    "drop"``) or admitted late into the next round (``"admit"``) carrying
    staleness >= 1.  ``idealized`` is True when the configuration can never
    produce a mask or staleness — `SimRunner` then leaves the BatchCtx
    untouched and the round is bit-for-bit the plain-engine round."""
    population: ClientPopulation
    fraction: float = 1.0
    deadline: float | None = None
    straggler: str = "drop"              # drop | admit
    sampler: str = "uniform"
    clock: VirtualClock = field(default_factory=VirtualClock)
    _pending_since: np.ndarray = None    # (K,) agg round a late upload is
    #                                      from; -1 = no pending upload
    _pending: dict = None                # cohort path: {id: agg round} — the
    #                                      O(#pending) form of the same book
    _round: int = 0

    # sync participation depends only on the per-round rng and the measured
    # leg bytes — never on training results — so a whole chunk of RoundPlans
    # can be drawn up front and fed through the engine's compiled
    # `chunk_rounds` scan as a (k, K) mask/stale plan (`SimRunner`)
    plannable = True

    def __post_init__(self):
        if self.straggler not in ("drop", "admit"):
            raise ValueError(self.straggler)
        if self.sampler not in SAMPLERS:
            raise ValueError(self.sampler)
        if self._pending_since is None:
            self._pending_since = np.full(self.population.n_clients, -1,
                                          np.int64)
        if self._pending is None:
            self._pending = {}

    @property
    def idealized(self) -> bool:
        return (self.fraction >= 1.0 and self.deadline is None
                and (self.sampler == "uniform"
                     or bool(np.all(self.population.availability >= 1.0))))

    @property
    def active_budget(self) -> int:
        """Static upper bound on per-round participants — the m of the
        participation-sparse round plane (``BatchCtx.active_budget``).  A
        sampled cohort is at most ceil(fraction * K); under ``straggler=
        "admit"`` the previous round's deadline-cut clients (a subset of its
        cohort) can join on top, so the bound doubles.  Every `RoundPlan`
        this scheduler emits satisfies ``mask.sum() <= active_budget`` by
        construction (property-tested in tests/test_sim_props.py)."""
        K = self.population.n_clients
        m = min(K, max(1, math.ceil(self.fraction * K)))
        if self.deadline is not None and self.straggler == "admit":
            m = min(K, 2 * m)
        return m

    def next_round(self, rng: np.random.Generator, up_bytes: float,
                   down_bytes: float) -> RoundPlan:
        pop = self.population
        t0 = self.clock.now
        selected = SAMPLERS[self.sampler](rng, pop, self.fraction)
        timing = self.clock.charge_sync_round(
            selected, pop.latency(up_bytes, down_bytes), self.deadline)

        pending = self._pending_since >= 0
        mask = timing.on_time | pending
        staleness = np.zeros(pop.n_clients, np.int64)
        staleness[pending] = self._round - self._pending_since[pending]
        self._pending_since[pending] = -1
        if self.straggler == "admit":
            # a late upload was computed from this round's broadcast labels:
            # it joins the next aggregation at staleness >= 1
            self._pending_since[timing.dropped] = self._round
        self._round += 1
        _publish_plan(int(mask.sum()), int(timing.dropped.sum()),
                      self.clock.now)
        return RoundPlan(mask, staleness, t0, self.clock.now, timing.dropped)

    def next_cohort(self, rng: np.random.Generator, up_bytes: float,
                    down_bytes: float) -> CohortPlan:
        """`next_round`'s O(m log K) form: the cohort is drawn as ids
        (`clients.COHORT_SAMPLERS` — Floyd / cached-CDF, no K-length
        workspace), latency is charged for the m members only, and the
        late-upload book is a dict keyed by id.  Same deadline / straggler
        semantics; the sampler draws differ from `next_round`'s mask
        samplers (different rng consumption), so the two forms describe
        the same fleet model, not the same realized rounds."""
        pop = self.population
        t0 = self.clock.now
        cohort = COHORT_SAMPLERS[self.sampler](rng, pop, self.fraction)
        timing = self.clock.charge_cohort(
            pop.latency_ids(cohort, up_bytes, down_bytes), self.deadline)
        on_time = cohort[timing.on_time]
        dropped = cohort[timing.dropped]

        # pending late uploads join this aggregation, stale by their lag;
        # a client both pending and freshly on-time keeps the pending lag
        # (mirrors the dense book, which overwrites fresh staleness 0)
        stale_of = {int(i): self._round - since
                    for i, since in self._pending.items()}
        self._pending.clear()
        ids = np.union1d(on_time, np.fromiter(stale_of, np.int64,
                                              len(stale_of)))
        staleness = np.array([stale_of.get(int(i), 0) for i in ids], np.int64)
        if self.straggler == "admit":
            for i in dropped:
                self._pending[int(i)] = self._round
        self._round += 1
        _publish_plan(int(ids.size), int(dropped.size), self.clock.now)
        return CohortPlan(ids, staleness, t0, self.clock.now, dropped)

    # ---------------------------------------------------------- checkpoint --
    def state(self) -> dict:
        return {"now": self.clock.now, "round": self._round,
                "pending_since": self._pending_since.tolist(),
                "pending": {str(k): int(v)
                            for k, v in self._pending.items()}}

    def set_state(self, s: dict) -> None:
        self.clock.now = float(s["now"])
        self._round = int(s["round"])
        self._pending_since = np.asarray(s["pending_since"], np.int64)
        self._pending = {int(k): int(v)
                         for k, v in s.get("pending", {}).items()}


@dataclass
class AsyncBufferScheduler:
    """Buffered-asynchronous aggregation (FedBuff-style).

    All clients train continuously; client k's upload lands every
    ``latency_k`` virtual seconds (lognormal jitter ``jitter_sigma`` per
    leg).  The server aggregates as soon as ``buffer_size`` uploads are
    buffered; contributors restart from the fresh broadcast, everyone else
    keeps training on the stale labels they last received — their eventual
    contribution is decayed by the algorithm's ``staleness_decay``."""
    population: ClientPopulation
    buffer_size: int = 2
    jitter_sigma: float = 0.0
    clock: VirtualClock = field(default_factory=VirtualClock)
    _arrival: np.ndarray = None          # (K,) next upload landing time
    _labels_from: np.ndarray = None      # dense path: (K,) label version
    #                                      each client trains against
    _heap: list = None                   # cohort path: (arrival, id) heap of
    #                                      MATERIALIZED arrivals only
    _labels: dict = None                 # cohort path: {id: label version} —
    #                                      O(#touched) form of the same book
    _cal: dict = None                    # cohort path: calendar-queue cursor
    #                                      (scalars only; see next_cohort)
    _round: int = 0

    idealized = False   # masks/staleness are structural in async mode
    plannable = False   # buffered-async rounds stay on the per-round path

    # how many equal-population (quantile) latency bands the calendar splits
    # the fleet into; each band materializes its heap entries only when the
    # pop frontier reaches its start time
    CAL_BUCKETS = 64

    @property
    def active_budget(self) -> int:
        """Exactly ``buffer_size`` uploads enter every aggregation, so the
        sparse round plane's budget is M — FedBuff-style async is the regime
        where computing only the active clients pays off most (M << K)."""
        return self.buffer_size

    def __post_init__(self):
        K = self.population.n_clients
        if not 1 <= self.buffer_size <= K:
            raise ValueError(f"buffer_size {self.buffer_size} not in [1, {K}]")
        if self._labels is None:
            self._labels = {}

    def _latency(self, rng, up_bytes, down_bytes) -> np.ndarray:
        lat = self.population.latency(up_bytes, down_bytes)
        if self.jitter_sigma > 0:
            lat = lat * rng.lognormal(0.0, self.jitter_sigma,
                                      self.population.n_clients)
        return lat

    def next_round(self, rng: np.random.Generator, up_bytes: float,
                   down_bytes: float) -> RoundPlan:
        K = self.population.n_clients
        if self._arrival is None:        # everyone starts training at t=0
            self._arrival = self._latency(rng, up_bytes, down_bytes)
        if self._labels_from is None:    # dense book, lazily (dense path only)
            self._labels_from = np.zeros(K, np.int64)
        t0 = self.clock.now
        order = np.argsort(self._arrival, kind="stable")
        idx = order[:self.buffer_size]
        t_agg = float(self._arrival[idx].max())
        self.clock.advance(max(0.0, t_agg - t0))

        mask = np.zeros(K, bool)
        mask[idx] = True
        staleness = np.zeros(K, np.int64)
        staleness[idx] = self._round - self._labels_from[idx]
        # contributors restart from the fresh broadcast (label version r+1)
        self._labels_from[idx] = self._round + 1
        self._arrival[idx] = (self.clock.now
                              + self._latency(rng, up_bytes, down_bytes)[idx])
        self._round += 1
        _publish_plan(int(mask.sum()), 0, self.clock.now)
        return RoundPlan(mask, staleness, t0, self.clock.now,
                         np.zeros(K, bool))

    def _open_bucket(self, rng: np.random.Generator) -> None:
        """Materialize the next calendar bucket: the vectorized numpy filter
        selects the ids whose BASE latency falls in the band, their (jittered)
        first arrivals become heap entries, and the cursor advances.  The
        (K,) base-latency vector is recomputed from the `ClientPopulation`
        model each opening — a transient vectorized pass, so the scheduler
        itself never holds per-client arrival state for untouched clients."""
        cal = self._cal
        j = cal["next"]
        lat = self.population.latency(cal["up"], cal["down"])
        bounds = cal["bounds"]
        if j == len(bounds) - 2:
            sel = lat >= bounds[j]       # last band is closed at hi
        else:
            sel = (lat >= bounds[j]) & (lat < bounds[j + 1])
        ids = np.flatnonzero(sel)
        t = lat[ids]
        if self.jitter_sigma > 0 and ids.size:
            t = t * rng.lognormal(0.0, self.jitter_sigma, ids.size)
        for i, ti in zip(ids, t):
            heapq.heappush(self._heap, (float(ti), int(i)))
        cal["next"] = j + 1

    def next_cohort(self, rng: np.random.Generator, up_bytes: float,
                    down_bytes: float) -> CohortPlan:
        """`next_round`'s lazy calendar-queue form (ROADMAP Open item 2b).

        The heap holds only MATERIALIZED arrivals: clients that already
        contributed (their re-armed next upload) plus the clients whose
        first arrival falls in an already-opened calendar bucket.  The
        first call computes only the ``CAL_BUCKETS + 1`` quantile boundaries
        of the base-latency distribution (equal-*population* bands, so a
        heavy-tailed fleet can't collapse into one band), and each band's
        first arrivals are materialized (`_open_bucket`) only when the pop
        frontier reaches its start time.  A million-client fleet whose
        simulation aggregates R rounds therefore holds O(popped + opened
        bands) heap entries instead of an eagerly heapified K, and the
        label-version book is an O(#touched) dict.

        Pops and re-arms stay O(M log heap) per round; a pop is taken only
        when no unopened band could still hold an earlier first arrival
        (``heap[0] < next band's start``).  Ties break on the lower id,
        matching the dense path's stable argsort.  With ``jitter_sigma=0``
        realized rounds equal `next_round`'s exactly (the pinned parity);
        with jitter a first arrival can land outside its base-latency band
        but is still released when the BASE band opens, so the realized
        stream is a valid sample of the same fleet model without a
        touched-set — it just differs from the eager-heap draw.  Use
        either form on one scheduler instance, not both (separate books).
        """
        pop = self.population
        if self._cal is None:            # everyone starts training at t=0:
            # O(n_buckets) QUANTILE boundaries, not equal-width bands — a
            # heavy-tailed fleet (lognormal compute) would put most of its
            # mass in the first linear band, re-eagerizing the queue; equal
            # *population* bands keep every opening ~K/n_buckets.  The (K,)
            # base-latency pass is transient; only the boundaries persist.
            lat = pop.latency(up_bytes, down_bytes)
            n_b = int(min(self.CAL_BUCKETS,
                          max(1, pop.n_clients // max(1, self.buffer_size))))
            bounds = np.quantile(lat, np.linspace(0.0, 1.0, n_b + 1))
            self._cal = {"bounds": [float(b) for b in bounds],
                         "next": 0, "up": float(up_bytes),
                         "down": float(down_bytes)}
            self._heap = []
        t0 = self.clock.now
        cal, popped = self._cal, []
        n_b = len(cal["bounds"]) - 1
        for _ in range(self.buffer_size):
            while cal["next"] < n_b and (
                    not self._heap
                    or self._heap[0][0] >= cal["bounds"][cal["next"]]):
                self._open_bucket(rng)
            popped.append(heapq.heappop(self._heap))
        self.clock.advance(max(0.0, max(t for t, _ in popped) - t0))
        ids = np.array(sorted(i for _, i in popped), np.int64)
        staleness = np.array([self._round - self._labels.get(int(i), 0)
                              for i in ids], np.int64)
        for i in ids:
            self._labels[int(i)] = self._round + 1
        lat = pop.latency_ids(ids, up_bytes, down_bytes)
        if self.jitter_sigma > 0:
            lat = lat * rng.lognormal(0.0, self.jitter_sigma, ids.size)
        for i, t in zip(ids, lat):
            heapq.heappush(self._heap, (self.clock.now + float(t), int(i)))
        self._round += 1
        _publish_plan(int(ids.size), 0, self.clock.now)
        return CohortPlan(ids, staleness, t0, self.clock.now,
                          np.zeros(0, np.int64))

    # ---------------------------------------------------------- checkpoint --
    def state(self) -> dict:
        """Everything the two arrival books need to resume: the dense path's
        (K,) arrays, and the cohort path's O(#touched) heap + label dict +
        calendar cursor (scalars).  An untouched book serializes as None/{}
        so a million-client cohort checkpoint stays O(#touched)."""
        return {"now": self.clock.now, "round": self._round,
                "arrival": (None if self._arrival is None
                            else self._arrival.tolist()),
                "labels_from": (None if self._labels_from is None
                                else self._labels_from.tolist()),
                "heap": (None if self._heap is None
                         else [[t, int(i)] for t, i in self._heap]),
                "labels": {str(k): int(v) for k, v in self._labels.items()},
                "cal": (None if self._cal is None else dict(self._cal))}

    def set_state(self, s: dict) -> None:
        self.clock.now = float(s["now"])
        self._round = int(s["round"])
        self._arrival = (None if s["arrival"] is None
                         else np.asarray(s["arrival"], np.float64))
        lf = s.get("labels_from")
        self._labels_from = (None if lf is None
                             else np.asarray(lf, np.int64))
        heap = s.get("heap")
        self._heap = (None if heap is None
                      else [(float(t), int(i)) for t, i in heap])
        if self._heap is not None:
            heapq.heapify(self._heap)
        self._labels = {int(k): int(v)
                        for k, v in s.get("labels", {}).items()}
        cal = s.get("cal")
        self._cal = None if cal is None else {
            "bounds": [float(b) for b in cal["bounds"]],
            "next": int(cal["next"]),
            "up": float(cal["up"]), "down": float(cal["down"])}
