"""Deterministic open-loop load generator for `ServeEngine` (a copy of
``repro/serve/loadgen.py``, pinned exactly equal to it in
tests/test_torch_loadgen.py).

Arrivals are open-loop (a Poisson process at ``rate`` requests per virtual
second, independent of server progress — the regime where queueing actually
builds) and everything is seeded and simulated in **virtual time**: the
clock advances by fixed per-operation costs (``prefill_cost`` per insert,
``step_cost`` per decode step) instead of reading a wall clock.  Two runs
with the same seed produce bit-identical schedules, latencies, and shed
sets on any machine, so runs are comparable across hosts and tests can
assert on them.  Wall-clock duration of the whole run is measured
separately (one perf_counter pair) purely for real tokens/sec throughput.

The port's engine runs eagerly and keeps no compiled-program counts, so
`summarize` has no ``compiles`` key (the reference reads the engine's
compile counts there).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..obs.metrics import percentile, percentiles
from .engine import ServeEngine
from .queue import AdmissionQueue


@dataclass(frozen=True)
class LoadSpec:
    """Workload shape: ``n_requests`` arrivals at ``rate`` req/s (virtual),
    prompt lengths and generation lengths drawn uniformly from the given
    inclusive ranges, token ids uniform over ``vocab``.  Fully determined
    by ``seed``."""
    n_requests: int = 32
    rate: float = 4.0
    prompt_len: tuple = (4, 48)
    max_new: tuple = (4, 16)
    vocab: int = 256
    seed: int = 0


def draw_arrivals(spec: LoadSpec) -> list:
    """The workload as ``(arrival_time, tokens, max_new)`` triples, arrival
    order.  Exponential inter-arrivals at ``spec.rate``."""
    rng = np.random.default_rng(spec.seed)
    gaps = rng.exponential(1.0 / spec.rate, size=spec.n_requests)
    arrivals = np.cumsum(gaps)
    out = []
    for t in arrivals:
        S = int(rng.integers(spec.prompt_len[0], spec.prompt_len[1] + 1))
        m = int(rng.integers(spec.max_new[0], spec.max_new[1] + 1))
        toks = tuple(int(x) for x in rng.integers(0, spec.vocab, size=S))
        out.append((float(t), toks, m))
    return out


def run_load(engine: ServeEngine, queue: AdmissionQueue, spec: LoadSpec, *,
             step_cost: float = 0.01, prefill_cost: float = 0.05,
             decode_chunk: int = 1, batch_insert: bool = False) -> dict:
    """Drive ``engine`` through the whole workload and aggregate the result.

    The virtual clock advances by ``prefill_cost`` per compiled prefill
    shot (one per request, or one per same-bucket group with
    ``batch_insert=True``) and ``step_cost`` per accounted decode step;
    when the server is idle it jumps to the next arrival.

    ``decode_chunk=d`` runs the fused d-step decode path: one dispatch and
    one host sync per chunk, mid-chunk finishers stamped at their true
    virtual sub-step, and the clock advanced by exactly the sub-steps the
    per-token loop would have executed.  ``batch_insert=True`` admits
    same-bucket groups (`AdmissionQueue.admit(group=True)`) through
    `ServeEngine.insert_batch`.  Both paths are token-identical to the
    defaults.  Returns the summary dict (see `summarize`) plus the raw
    ``responses`` list.
    """
    pending = draw_arrivals(spec)
    next_arrival = 0                    # index into pending
    now = 0.0
    responses = []
    wall0 = time.perf_counter()
    while True:
        while (next_arrival < len(pending)
               and pending[next_arrival][0] <= now):
            t, toks, m = pending[next_arrival]
            queue.submit(toks, m, now=t)
            next_arrival += 1
        if batch_insert:
            while True:
                reqs = queue.admit(now, len(engine.free_slots()), group=True)
                if not reqs:
                    break
                now += prefill_cost     # one compiled shot per group
                engine.insert_batch(reqs, now)
        else:
            for req in queue.admit(now, len(engine.free_slots())):
                now += prefill_cost
                engine.insert(req, now)
        if engine.n_active:
            steps_before = engine.n_steps
            now += step_cost            # sub-step 0 happens at this time
            engine.step(now, decode_chunk=decode_chunk, step_dt=step_cost)
            now += (engine.n_steps - steps_before - 1) * step_cost
            responses.extend(engine.pop_completed())
        elif next_arrival < len(pending):
            now = pending[next_arrival][0]   # idle: jump to the next arrival
        elif len(queue):                     # pragma: no cover - queue can
            now += step_cost                 # only be non-empty mid-flight
        else:
            break
    wall_s = time.perf_counter() - wall0
    responses.extend(engine.pop_completed())
    responses.extend(queue.shed)
    return summarize(responses, makespan=now, wall_s=wall_s,
                     queue=queue, engine=engine)


def summarize(responses, *, makespan: float, wall_s: float,
              queue: Optional[AdmissionQueue] = None,
              engine: Optional[ServeEngine] = None) -> dict:
    """p50/p90/p99 latency + time-to-first-token (virtual seconds),
    throughput (generated tokens per virtual second, and per wall second),
    and exact shed accounting.  Percentiles all come from the one shared
    implementation in `obs.metrics`; an empty series (e.g. the shed
    percentiles of a run that shed nothing) reports ``None`` — JSON null —
    not a -1.0 sentinel, so downstream report code must guard for it.
    Shed requests' queue-wait time is accounted (``queue_wait_*`` spans
    served *and* shed responses, and ``shed_wait_*`` reports how long
    dropped requests sat before being shed) rather than silently vanishing
    from the latency picture."""
    done = [r for r in responses if not r.shed]
    shed = [r for r in responses if r.shed]
    n_tokens = sum(len(r.tokens) for r in done)

    def pcts(prefix, xs):
        return {f"{prefix}_{k}_s": v
                for k, v in percentiles(xs, empty=None).items()}

    out = {
        "completed": len(done),
        "shed": len(shed),
        "tokens": n_tokens,
        "makespan_virtual_s": makespan,
        "wall_s": wall_s,
        **pcts("latency", [r.latency for r in done]),
        **pcts("ttft", [r.ttft for r in done]),
        "queue_delay_p50_s": percentile([r.queue_delay for r in done], 50,
                                        empty=None),
        # every submitted request's time-in-queue, shed included — the
        # number that shows overload instead of hiding it in the shed bin
        **pcts("queue_wait", [r.queue_wait for r in responses]),
        **pcts("shed_wait", [r.queue_wait for r in shed]),
        "throughput_tok_per_virtual_s":
            n_tokens / makespan if makespan > 0 else 0.0,
        "throughput_tok_per_wall_s":
            n_tokens / wall_s if wall_s > 0 else 0.0,
        "responses": responses,
    }
    if queue is not None:
        out["n_submitted"] = queue.n_submitted
        out["n_admitted"] = queue.n_admitted
    if engine is not None:
        out["decode_steps"] = engine.n_steps
        out["decode_dispatches"] = engine.n_dispatches
        out["prefill_shots"] = engine.n_prefill_shots
        out["weights_version"] = engine.version
    return out
