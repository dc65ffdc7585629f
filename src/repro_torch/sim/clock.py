"""Virtual event clock: wallclock accounting for one federated round.

The clock charges each selected client the full leg sequence — broadcast
download, local compute, payload upload — using the *measured* codec bytes
from `repro.core.wire` (via ``FedEngine.measured_leg_bytes``), never analytic
estimates.  A straggler deadline either drops late clients from the round
(``"drop"``) or admits their upload into the next aggregation (``"admit"``,
where it arrives stale).  All per-client math is vectorized NumPy.

A copy of ``repro/sim/clock.py`` (numpy only), held exactly equal to it
on the same seeds by ``tests/test_torch_sim.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class RoundTiming:
    """What one round cost in virtual time."""
    duration: float            # seconds this round occupied on the wallclock
    latency: np.ndarray        # (K,) per-client full-leg latency (selected
    #                            clients; unselected entries hold +inf)
    on_time: np.ndarray        # (K,) bool — selected and inside the deadline
    dropped: np.ndarray        # (K,) bool — selected but past the deadline


@dataclass(frozen=True)
class CohortTiming:
    """`RoundTiming`'s O(m) form: arrays align with a cohort's (m,) ids
    instead of the (K,) population."""
    duration: float
    latency: np.ndarray        # (m,) per-member full-leg latency
    on_time: np.ndarray        # (m,) bool
    dropped: np.ndarray        # (m,) bool


@dataclass
class VirtualClock:
    """Monotone virtual time.  ``now`` is checkpointed by `SimRunner` so a
    resumed simulation continues the same wallclock axis."""
    now: float = 0.0

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"time must not run backwards (dt={dt})")
        self.now += float(dt)
        return self.now

    def charge_sync_round(self, selected: np.ndarray, latency: np.ndarray,
                          deadline: float | None = None) -> RoundTiming:
        """Synchronous (FedAvg-style) round: the server waits for every
        selected client, or until ``deadline`` seconds — whichever is first.
        Clients past the deadline are marked dropped; if *everyone* misses
        it, the single fastest selected client is kept (an empty round would
        silently degenerate to the uniform-fallback aggregate).  Advances
        ``now`` by the round duration."""
        lat = np.where(selected, latency, np.inf)
        if deadline is None:
            on_time = selected.copy()
        else:
            on_time = selected & (lat <= deadline)
            if selected.any() and not on_time.any():
                fastest = int(np.argmin(lat))
                on_time = np.zeros_like(selected)
                on_time[fastest] = True
        dropped = selected & ~on_time
        if not selected.any():
            duration = 0.0
        elif dropped.any():
            # the round closed at the deadline (or at the forced-kept
            # fastest client, whichever came later)
            duration = float(max(deadline, np.min(lat[on_time])))
        else:
            duration = float(np.max(lat[on_time]))
        self.advance(duration)
        return RoundTiming(duration, lat, on_time, dropped)

    def charge_cohort(self, latency: np.ndarray,
                      deadline: float | None = None) -> CohortTiming:
        """`charge_sync_round` over a cohort's (m,) latencies — identical
        deadline/forced-keep/duration semantics, but every array is cohort-
        sized: the million-client path charges m members, never K lanes."""
        lat = np.asarray(latency, np.float64)
        m = lat.shape[0]
        if deadline is None:
            on_time = np.ones(m, bool)
        else:
            on_time = lat <= deadline
            if m and not on_time.any():
                on_time = np.zeros(m, bool)
                on_time[int(np.argmin(lat))] = True
        dropped = ~on_time if m else np.zeros(0, bool)
        if m == 0:
            duration = 0.0
        elif dropped.any():
            duration = float(max(deadline, np.min(lat[on_time])))
        else:
            duration = float(np.max(lat[on_time]))
        self.advance(duration)
        return CohortTiming(duration, lat, on_time, dropped)
