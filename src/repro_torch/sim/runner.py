"""`SimRunner` and `CohortRunner`: federation simulation around any
`FedEngine` (mirrors ``repro/sim/runner.py``).

The runners do not fork the training loop.  A round is an ordinary
``FedEngine.run`` round; the scheduler's `RoundPlan` reaches it as
``BatchCtx.mask`` / ``.stale``, through a ``ctx_plan`` of a whole chunk
when sync participation can be planned ahead, else through the engine's
``on_ctx`` hook one round at a time.  Around the rounds the runners keep
the books the engine cannot: the virtual clock (charged from the *measured*
per-leg codec bytes, measured once), the cumulative byte ledger and a
`SimHistory` of accuracy against virtual wallclock.  ``save_state`` /
``load_state`` checkpoint the engine state with a ``.sim.json`` sidecar
(scheduler books, virtual clock, sim history, bytes) and, for
`CohortRunner`, the client store, so a resumed simulation continues the
same time axis.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..checkpoint import named_leaves
from ..core.algorithms import RoundState
from ..core.cohort import ClientStore, build_slab, slab_ctx_plan
from ..core.engine import FedEngine
from ..obs import trace as obs
from .history import SimHistory
from .scheduler import RoundPlan


def _publish_chunk(runner, plans, up_bytes: float, down_bytes: float) -> None:
    """Per-chunk metrics both runners share: the wire-byte ledger and the
    participation the schedule delivered."""
    reg = obs.current_registry()
    if reg is None:
        return
    n_part = sum(p.n_participants for p in plans)
    reg.counter("sim.up_bytes").inc(int(up_bytes) * n_part)
    reg.counter("sim.down_bytes").inc(int(down_bytes) * len(plans))
    reg.counter("sim.participant_rounds").inc(n_part)
    reg.gauge("sim.cum_bytes").set(runner.cum_bytes)


def _plan_rows(mask: np.ndarray, stale: np.ndarray) -> dict:
    """A chunk's (k, lanes) mask/stale ``ctx_plan`` as CPU tensors (the
    engine moves each chunk's rows to the device in one copy)."""
    return {"mask": torch.as_tensor(mask, dtype=torch.float32),
            "stale": torch.as_tensor(stale, dtype=torch.int32)}


class _Books:
    """The bookkeeping both runners share: the byte ledger, the sim
    history and the checkpoint sidecar."""

    def _record(self, eng: FedEngine, n_hist: int, r0: int, plans,
                dropped, stale, extra=None) -> None:
        up_bytes, down_bytes = self._leg_bytes
        eng_recs = {rec["round"]: rec for rec in eng.history[n_hist:]}
        for i, plan in enumerate(plans):
            self.cum_bytes += up_bytes * plan.n_participants + down_bytes
            rec = {"round": r0 + i + 1,
                   "t_round": plan.duration, "t_cum": plan.t_end,
                   "participants": plan.n_participants,
                   "dropped": dropped(plan),
                   "mean_staleness": stale(plan),
                   "up_bytes": up_bytes * plan.n_participants,
                   "down_bytes": down_bytes,
                   "cum_bytes": self.cum_bytes, **(extra or {})}
            eng_rec = eng_recs.get(r0 + i + 1)
            if eng_rec is not None:            # the engine logged this round
                rec.update({k: v for k, v in eng_rec.items() if k not in rec})
            self.history.append(rec)
        _publish_chunk(self, plans, up_bytes, down_bytes)

    def _sidecar(self, path: str) -> str:
        return path + ".sim.json"

    def _save_books(self, path: str) -> None:
        with open(self._sidecar(path), "w") as f:
            json.dump({"scheduler": self.scheduler.state(),
                       "history": self.history.records,
                       "cum_bytes": self.cum_bytes,
                       "seed": self.seed}, f, default=float)

    def _load_books(self, path: str) -> None:
        sidecar = self._sidecar(path)
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                raw = json.load(f)
            self.scheduler.set_state(raw["scheduler"])
            self.history = SimHistory(records=raw["history"])
            self.cum_bytes = int(raw["cum_bytes"])


@dataclass
class SimRunner(_Books):
    """Drive ``engine`` under ``scheduler``'s participation and timing.

    ``seed`` feeds a per-round ``np.random.default_rng([seed, round])``, so
    participation draws are reproducible and a resumed run replays the
    same fleet without saving generator state."""
    engine: FedEngine
    scheduler: Any                      # SyncScheduler | AsyncBufferScheduler
    seed: int = 0
    history: SimHistory = field(default_factory=SimHistory)
    cum_bytes: int = 0
    _leg_bytes: Optional[tuple] = None  # measured (up, down) bytes

    def _hook(self, plan: RoundPlan, budget=None):
        if self.scheduler.idealized:
            return None                  # ctx untouched: the plain round
        dev = self.engine.device
        mask = torch.as_tensor(plan.mask, dtype=torch.float32, device=dev)
        stale = torch.as_tensor(plan.staleness, dtype=torch.int32, device=dev)

        def on_ctx(r, ctx):
            return dataclasses.replace(ctx, mask=mask, stale=stale,
                                       active_budget=budget)

        return on_ctx

    def _budget(self, active_budget, plans) -> Optional[int]:
        """The sparse budget of one engine call: ``"auto"`` takes the
        scheduler's static bound, an int is checked against the plans,
        None keeps the dense masked round; a budget >= K buys nothing and
        becomes None."""
        if active_budget == "auto":
            active_budget = getattr(self.scheduler, "active_budget", None)
        if active_budget is None:
            return None
        K = self.scheduler.population.n_clients
        if active_budget >= K:
            return None
        need = max(int(p.mask.sum()) for p in plans)
        if need > active_budget:
            raise ValueError(
                f"active_budget {active_budget} < {need} scheduled "
                f"participants: the sparse round would skip clients that "
                f"carry aggregation weight")
        if min(int(p.mask.sum()) for p in plans) < 1:
            raise ValueError(
                "sparse rounds need >= 1 participant per round (an empty "
                "round's aggregation falls back to uniform over K, which "
                "needs the uploads the sparse plane never computes); pass "
                "active_budget=None for this schedule")
        return int(active_budget)

    def run(self, state: RoundState, data, rounds: Optional[int] = None,
            weights=None, log_every: int = 1, chunk_rounds: int = 1,
            active_budget="auto", overlap: bool = False) -> RoundState:
        """Drive ``rounds`` virtual rounds.  ``chunk_rounds=k`` with a
        plannable (sync) scheduler draws k `RoundPlan`s up front and runs
        them as one engine chunk with a (k, K) mask/stale ``ctx_plan``;
        async scheduling runs one round at a time through ``on_ctx``.
        ``active_budget="auto"`` takes the scheduler's static bound on
        participants, so a 10%-participation fleet computes ~10% of the
        client stack a round; an int overrides it, None forces the dense
        masked round.  ``overlap`` is passed to the chunked engine run."""
        eng = self.engine
        rounds = eng.algo.hp.rounds if rounds is None else rounds
        if self._leg_bytes is None:
            self._leg_bytes = eng.measured_leg_bytes(state, data)
        up_bytes, down_bytes = self._leg_bytes
        fused = (chunk_rounds > 1
                 and getattr(self.scheduler, "plannable", False))
        prev_hook = eng.on_ctx
        try:
            done = 0
            while done < rounds:
                k = min(chunk_rounds, rounds - done) if fused else 1
                r0 = eng.rounds_done
                with obs.span("sim.plan", "sim", rounds=k, start_round=r0):
                    plans = [self.scheduler.next_round(
                        np.random.default_rng([self.seed, r0 + i]),
                        up_bytes, down_bytes) for i in range(k)]
                n_hist = len(eng.history)
                budget = (None if self.scheduler.idealized
                          else self._budget(active_budget, plans))
                if fused:
                    eng.on_ctx = None
                    ctx_plan = (None if self.scheduler.idealized else
                                _plan_rows(np.stack([p.mask for p in plans]),
                                           np.stack([p.staleness
                                                     for p in plans])))
                    state = eng.run(state, data, rounds=k, weights=weights,
                                    log_every=log_every, chunk_rounds=k,
                                    ctx_plan=ctx_plan, active_budget=budget,
                                    overlap=overlap)
                else:
                    eng.on_ctx = self._hook(plans[0], budget)
                    state = eng.run(state, data, rounds=1, weights=weights,
                                    log_every=log_every)
                self._record(
                    eng, n_hist, r0, plans,
                    dropped=lambda p: int(p.dropped.sum()),
                    stale=lambda p: float(p.staleness[p.mask].mean()
                                          if p.mask.any() else 0.0))
                done += k
        finally:
            eng.on_ctx = prev_hook
        return state

    # ------------------------------------------------------- checkpointing --
    def save_state(self, path: str, state: RoundState) -> None:
        """Engine checkpoint + the ``.sim.json`` sidecar."""
        self.engine.save_state(path, state)
        self._save_books(path)

    def load_state(self, path: str, like: RoundState) -> RoundState:
        state = self.engine.load_state(path, like)
        self._load_books(path)
        return state


@dataclass
class CohortRunner(_Books):
    """Cohort rounds: `SimRunner`'s million-client form.

    Nothing in a round is O(K): the scheduler plans `CohortPlan`s (id
    arrays), client state lives on the host in a `ClientStore` keyed by
    global id (made lazily), each chunk's data comes from the provider's
    ``slab(ids)``, and the engine runs its ordinary rounds over an S-lane
    slab with ``BatchCtx.cohort`` holding the lanes' ids.  Fed the same
    plans, it equals `SimRunner`'s dense masked rounds bitwise on the CPU
    (tests/test_torch_cohort.py).

    ``state`` passed to ``run`` holds the server side only (e.g.
    ``algo.init_server``); ``store`` is None for algorithms whose client
    state is ephemeral (FedAvg)."""
    engine: FedEngine
    scheduler: Any
    provider: Any                       # ArrayProvider | SyntheticProvider
    store: Optional[ClientStore] = None
    seed: int = 0
    history: SimHistory = field(default_factory=SimHistory)
    cum_bytes: int = 0
    peak_slab_bytes: int = 0
    _leg_bytes: Optional[tuple] = None

    def resident_bytes(self) -> int:
        """Host bytes of all stored client state (flat in K)."""
        return 0 if self.store is None else self.store.resident_bytes()

    def _probe_state(self, state: RoundState) -> RoundState:
        """A one-lane slab state for the byte measurement (it computes one
        client's payload, so a client lane must exist)."""
        if self.store is None:
            return state
        return dataclasses.replace(state,
                                   clients=self.store.gather(np.zeros(1)))

    def run(self, state: RoundState, rounds: Optional[int] = None,
            weights=None, log_every: int = 1,
            chunk_rounds: int = 1) -> RoundState:
        """Drive ``rounds`` virtual rounds, ``chunk_rounds`` at a time:
        each chunk's cohorts are planned up front, their sorted union is
        one slab of fixed size S = min(K, chunk_rounds * budget), and the
        chunk runs as one engine chunk with the (k, S) mask/stale plan.
        Within the slab the engine's ``active_budget`` plane computes the
        round's participants when the budget is below S."""
        eng = self.engine
        sched = self.scheduler
        rounds = eng.algo.hp.rounds if rounds is None else rounds
        K = sched.population.n_clients
        budget = int(getattr(sched, "active_budget", K))
        if self._leg_bytes is None:
            self._leg_bytes = eng.measured_leg_bytes(
                self._probe_state(state), self.provider.slab(np.zeros(1)))
        up_bytes, down_bytes = self._leg_bytes
        done = 0
        while done < rounds:
            k = min(chunk_rounds, rounds - done)
            r0 = eng.rounds_done
            with obs.span("sim.plan", "sim", rounds=k, start_round=r0):
                plans = [sched.next_cohort(
                    np.random.default_rng([self.seed, r0 + i]),
                    up_bytes, down_bytes) for i in range(k)]
                S = min(K, k * budget)
                slab_ids, n_real = build_slab([p.ids for p in plans], S)
                plan_np = slab_ctx_plan(plans, slab_ids, n_real)
            with obs.span("cohort.gather", "cohort", slab=S, real=n_real):
                clients = (self.store.gather(slab_ids)
                           if self.store is not None else state.clients)
            with obs.span("cohort.provider", "cohort", slab=S):
                data = self.provider.slab(slab_ids)
            sstate = dataclasses.replace(state, clients=clients)
            self.peak_slab_bytes = max(self.peak_slab_bytes, sum(
                t.numel() * t.element_size()
                for _, t in named_leaves(clients)))
            n_hist = len(eng.history)
            sstate = eng.run(
                sstate, data, rounds=k, weights=weights, log_every=log_every,
                chunk_rounds=k,
                ctx_plan=_plan_rows(plan_np["mask"], plan_np["stale"]),
                active_budget=(budget if budget < S else None),
                cohort=torch.as_tensor(slab_ids, device=eng.device),
                population=K)
            if self.store is not None:
                with obs.span("cohort.scatter", "cohort", real=n_real):
                    self.store.scatter(slab_ids, sstate.clients, n_real)
            state = dataclasses.replace(sstate, clients=state.clients)
            self._record(
                eng, n_hist, r0, plans,
                dropped=lambda p: int(p.dropped_ids.size),
                stale=lambda p: float(p.staleness.mean() if p.ids.size
                                      else 0.0),
                extra={"resident_bytes": self.resident_bytes()})
            reg = obs.current_registry()
            if reg is not None:
                reg.gauge("cohort.resident_bytes").set(self.resident_bytes())
                reg.gauge("cohort.peak_slab_bytes").set(self.peak_slab_bytes)
                reg.histogram("cohort.slab_real").observe(float(n_real))
            done += k
        return state

    # ------------------------------------------------------- checkpointing --
    def _store_path(self, path: str) -> str:
        return path + ".store"

    def save_state(self, path: str, state: RoundState) -> None:
        """Engine checkpoint (the server side, round counter and history),
        the client store and the ``.sim.json`` sidecar."""
        self.engine.save_state(path, state)
        if self.store is not None:
            self.store.save(self._store_path(path))
        self._save_books(path)

    def load_state(self, path: str, like: RoundState) -> RoundState:
        state = self.engine.load_state(path, like)
        if self.store is not None and os.path.exists(self._store_path(path)):
            self.store.load(self._store_path(path))
        self._load_books(path)
        return state
