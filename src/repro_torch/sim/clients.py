"""Per-client device/link profiles and participation samplers.

The paper's efficiency claim is plotted against *cumulative upload time* on
heterogeneous mobile devices (Figs. 5-8), so a reproduction needs a model of
who shows up each round and how slow their link is.  A `ClientPopulation`
holds vectorized per-client profiles (compute seconds per round, uplink and
downlink bytes/s, availability); factories draw them from configurable
distributions — lognormal link rates are the standard mobile-network model.

Everything here is plain NumPy: the sim layer runs at Python level between
rounds; only the resulting participation mask / staleness vector crosses
into the round (as `BatchCtx.mask` / ``.stale``).

A copy of ``repro/sim/clients.py`` (numpy only), held exactly equal to it
on the same seeds by ``tests/test_torch_sim.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ClientPopulation:
    """Vectorized per-client profiles; all arrays are shape (K,)."""
    compute_time: np.ndarray     # seconds of local work per round
    uplink: np.ndarray           # bytes/s client -> server
    downlink: np.ndarray         # bytes/s server -> client
    availability: np.ndarray     # P(client reachable in a round), in (0, 1]

    def __post_init__(self):
        for name in ("compute_time", "uplink", "downlink", "availability"):
            setattr(self, name, np.asarray(getattr(self, name), np.float64))

    @property
    def n_clients(self) -> int:
        return int(self.compute_time.shape[0])

    def latency(self, up_bytes: float, down_bytes: float) -> np.ndarray:
        """(K,) seconds for one round: receive the broadcast, compute, then
        upload — ``down/downlink + compute + up/uplink`` per client."""
        return (down_bytes / self.downlink + self.compute_time
                + up_bytes / self.uplink)

    def latency_ids(self, ids: np.ndarray, up_bytes: float,
                    down_bytes: float) -> np.ndarray:
        """`latency` restricted to the (m,) global ids of one cohort — the
        O(m) path the cohort schedulers charge, which never materializes a
        K-length latency workspace."""
        ids = np.asarray(ids, np.int64)
        return (down_bytes / self.downlink[ids] + self.compute_time[ids]
                + up_bytes / self.uplink[ids])

    def availability_cdf(self) -> np.ndarray:
        """Cumulative availability weights, built once (O(K)) and cached so
        every weighted draw is an O(log K) ``searchsorted`` instead of the
        O(K) normalization scan ``rng.choice(p=...)`` performs per call.
        The cache keys on the identity of the ``availability`` array:
        replacing the attribute invalidates it; in-place edits
        (``pop.availability[:] = ...``) require dropping ``_avail_cdf``."""
        cached = getattr(self, "_avail_cdf", None)
        if cached is None or cached[0] is not self.availability:
            self._avail_cdf = (self.availability,
                               np.cumsum(self.availability))
        return self._avail_cdf[1]

    # ----------------------------------------------------------- factories --
    @classmethod
    def uniform(cls, K: int, compute_time: float = 1.0,
                uplink: float = 1e6, downlink: float = 1e7,
                availability: float = 1.0) -> "ClientPopulation":
        """Homogeneous population — the idealized-engine equivalence case."""
        ones = np.ones(K)
        return cls(compute_time * ones, uplink * ones, downlink * ones,
                   availability * ones)

    @classmethod
    def lognormal(cls, seed: int, K: int, compute_median: float = 1.0,
                  compute_sigma: float = 0.5, uplink_median: float = 1e6,
                  uplink_sigma: float = 1.0, downlink_factor: float = 10.0,
                  availability: tuple[float, float] = (1.0, 1.0)
                  ) -> "ClientPopulation":
        """Heterogeneous mobile fleet: lognormal compute and link rates
        (medians in seconds and bytes/s), downlink a fixed multiple of the
        uplink (asymmetric consumer links), availability uniform in the
        given range."""
        rng = np.random.default_rng(seed)
        compute = compute_median * rng.lognormal(0.0, compute_sigma, K)
        up = uplink_median * rng.lognormal(0.0, uplink_sigma, K)
        avail = rng.uniform(availability[0], availability[1], K)
        return cls(compute, up, downlink_factor * up, avail)


# ------------------------------------------------- participation samplers ----
def _cohort_size(K: int, fraction: float) -> int:
    return min(K, max(1, int(round(fraction * K))))


def floyd_sample(rng: np.random.Generator, K: int, m: int) -> np.ndarray:
    """Floyd's algorithm: m distinct uniform draws from [0, K) in O(m) time
    and memory — no K-length permutation/workspace, so drawing 100 of 10^6
    clients costs the same as 100 of 10^3.  Returns sorted ids."""
    if m >= K:
        return np.arange(K, dtype=np.int64)
    chosen = set()
    for j in range(K - m, K):
        t = int(rng.integers(0, j + 1))
        chosen.add(j if t in chosen else t)
    return np.fromiter(sorted(chosen), np.int64, len(chosen))


def weighted_draw_ids(rng: np.random.Generator, pop: ClientPopulation,
                      n: int) -> np.ndarray:
    """n availability-weighted draws (with replacement) via the cached CDF:
    O(n log K) per call after the one-time O(K) ``availability_cdf`` build."""
    cdf = pop.availability_cdf()
    u = rng.random(n) * cdf[-1]
    return np.searchsorted(cdf, u, side="right").astype(np.int64)


def cohort_uniform(rng: np.random.Generator, pop: ClientPopulation,
                   fraction: float = 1.0) -> np.ndarray:
    """Uniform cohort draw returning sorted (m,) global ids — the O(m log K)
    counterpart of `sample_uniform` (same exact cohort size, no (K,) mask)."""
    K = pop.n_clients
    return floyd_sample(rng, K, _cohort_size(K, fraction))


def cohort_available(rng: np.random.Generator, pop: ClientPopulation,
                     fraction: float = 1.0) -> np.ndarray:
    """Availability-weighted cohort draw returning sorted (<= m,) global
    ids.  Two stages, mirroring `sample_available`'s model without its
    per-draw O(K) scans: candidates come from the cached-CDF weighted draw
    (who the server *tries*), and each candidate answers w.p. its
    availability (the reachability coin).  Distinctness by rejection, with
    a bounded attempt budget; if nobody answers, fall back to the single
    most-available client so a round is never empty."""
    K = pop.n_clients
    m = _cohort_size(K, fraction)
    picked: set[int] = set()
    attempts, budget = 0, max(16 * m, 64)
    while len(picked) < m and attempts < budget:
        n = min(budget - attempts, max(m - len(picked), 8))
        cand = weighted_draw_ids(rng, pop, n)
        accept = rng.random(n) < pop.availability[cand]
        picked.update(int(c) for c in cand[accept])
        attempts += n
    if not picked:
        picked = {int(np.argmax(pop.availability))}
    return np.fromiter(sorted(picked), np.int64, len(picked))[:m]


COHORT_SAMPLERS = {"uniform": cohort_uniform, "available": cohort_available}


def sample_uniform(rng: np.random.Generator, pop: ClientPopulation,
                   fraction: float = 1.0) -> np.ndarray:
    """Uniform-K sampling: exactly ``max(1, round(fraction * K))`` clients,
    chosen uniformly without replacement.  Returns a (K,) bool mask.

    All samplers share the ``(rng, pop, fraction) -> mask`` signature so
    `SAMPLERS` is a real registry (`SyncScheduler` dispatches by name)."""
    K = pop.n_clients
    k = max(1, int(round(fraction * K)))
    mask = np.zeros(K, bool)
    mask[rng.choice(K, size=min(k, K), replace=False)] = True
    return mask


def sample_available(rng: np.random.Generator, pop: ClientPopulation,
                     fraction: float = 1.0) -> np.ndarray:
    """Availability-weighted sampling: candidates are drawn proportional to
    availability and each answers with probability its availability; falls
    back to the single most-available client if nobody answers.  The draw
    itself is `cohort_available` — O(m log K) per call against the cached
    availability CDF, where the previous implementation re-ran two O(K)
    scans (a K-wide reachability coin flip plus ``rng.choice(p=...)``'s
    normalization) on *every* round.  Only the returned (K,) mask is still
    dense; cohort-resident callers take the id form directly."""
    mask = np.zeros(pop.n_clients, bool)
    mask[cohort_available(rng, pop, fraction)] = True
    return mask


SAMPLERS = {"uniform": sample_uniform, "available": sample_available}
