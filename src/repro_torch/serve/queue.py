"""Admission queue in front of `repro_torch.serve.ServeEngine`.

Requests land here first; the queue buckets them by prompt length (the
bucket picks the prefill length that serves the request — see
`ServeEngine.prefill_len`), holds them FIFO *within* each bucket, sheds
requests that overstay ``timeout`` or arrive while the backlog is at
``max_queue`` (overload protection: a bounded queue turns a latency
collapse into explicit, accounted shed), and stamps per-request latency
bookkeeping (arrival / admission / first token / finish) from which
latency percentiles (p50/p99) are computed.

Everything here is host-side Python over small ints, so the queue
invariants are testable without a device.  A copy of the reference's
``repro/serve/queue.py``, pinned exactly equal to it
(tests/test_torch_serve.py); the reference's telemetry (spans, gauges and
counters) is left out until the port's telemetry slice.
"""
from __future__ import annotations

import itertools
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence


@dataclass(frozen=True)
class Request:
    """One generation request.  ``tokens`` is the prompt (host ints);
    ``arrival`` is the submitting clock's timestamp (virtual or wall —
    the queue never reads a clock itself, callers pass ``now``)."""
    id: int
    tokens: tuple
    max_new_tokens: int
    arrival: float = 0.0

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)


@dataclass(frozen=True)
class Response:
    """A finished (or shed) request with its latency bookkeeping.
    ``weights_version`` is the serving-weight version counter stamped by
    `ServeEngine` — after a live hot-swap it tells which federated round's
    distilled model produced the tokens."""
    id: int
    prompt_len: int
    tokens: tuple                       # generated tokens (empty if shed)
    weights_version: int = -1
    arrival: float = 0.0
    admitted_at: float = -1.0
    first_token_at: float = -1.0
    finished_at: float = -1.0
    shed: bool = False

    @property
    def latency(self) -> float:
        """Full arrival-to-finish latency (the number p50/p99 report on)."""
        return self.finished_at - self.arrival

    @property
    def queue_delay(self) -> float:
        return self.admitted_at - self.arrival

    @property
    def queue_wait(self) -> float:
        """Time spent in the admission queue — admission for served
        requests, the shed moment for shed ones.  Unlike ``queue_delay``
        this is well-defined for every response, so shed requests' waiting
        time lands in the latency accounting instead of vanishing."""
        end = self.finished_at if self.shed else self.admitted_at
        return end - self.arrival

    @property
    def ttft(self) -> float:
        """Time to first generated token."""
        return self.first_token_at - self.arrival


def bucket_of(prompt_len: int, buckets: Sequence[int]) -> int:
    """The prefill bucket serving a prompt: the largest bucket <= the prompt
    length (the engine prefills that prefix in one shot and feeds the short
    tail through the decode step).  Prompts shorter than every bucket fall
    back to their exact length (`ServeEngine` always has bucket 1)."""
    fit = [b for b in buckets if b <= prompt_len]
    return max(fit) if fit else prompt_len


@dataclass
class AdmissionQueue:
    """Bounded, bucketed FIFO with timeout shedding.

    ``buckets`` must match the serving engine's (they name its prefill
    lengths).  ``timeout``: a request still queued ``timeout``
    after arrival is shed at the next ``admit``/``shed_expired`` call;
    ``max_queue``: a submit beyond this backlog is shed immediately.
    ``None`` disables either policy.  Shed requests come back as
    `Response(shed=True)` so every submitted request is accounted exactly
    once (queue invariant, hypothesis-pinned)."""
    buckets: Sequence[int] = (16, 32, 64, 128)
    timeout: Optional[float] = None
    max_queue: Optional[int] = None

    def __post_init__(self):
        self.buckets = tuple(sorted(self.buckets))
        self._q: "OrderedDict[int, deque]" = OrderedDict()   # bucket -> FIFO
        self._ids = itertools.count()
        self.n_submitted = 0
        self.n_admitted = 0
        self.shed: list = []            # Response(shed=True), in shed order

    # ------------------------------------------------------------- intake ----
    def submit(self, tokens: Iterable[int], max_new_tokens: int,
               now: float = 0.0) -> Request:
        """Enqueue a request (or shed it on the spot if the backlog is at
        ``max_queue``).  Returns the Request either way; a shed submit is
        visible in ``self.shed``."""
        req = Request(id=next(self._ids), tokens=tuple(int(t) for t in tokens),
                      max_new_tokens=int(max_new_tokens), arrival=float(now))
        self.n_submitted += 1
        if self.max_queue is not None and len(self) >= self.max_queue:
            self.shed.append(self._shed_response(req, now))
            return req
        b = bucket_of(req.prompt_len, self.buckets)
        self._q.setdefault(b, deque()).append(req)
        return req

    # ---------------------------------------------------------- admission ----
    def admit(self, now: float, free_slots: int, group: bool = False) -> list:
        """Pop up to ``free_slots`` requests, oldest-arrival first across
        buckets (which preserves FIFO within every bucket), after shedding
        everything past ``timeout``.

        ``group=True`` is the batched-prefill mode: every returned request
        shares the bucket of the globally oldest queued request, popped
        FIFO from that bucket only — a group `ServeEngine.insert_batch`
        can admit in one prefill shot.  Other buckets wait for the next
        ``admit`` call, so per-bucket FIFO and oldest-bucket-first order
        both survive grouping."""
        self.shed_expired(now)
        out = []
        bucket = None
        while len(out) < free_slots:
            req = self._pop_oldest(bucket)
            if req is None:
                break
            if group and bucket is None:
                bucket = bucket_of(req.prompt_len, self.buckets)
            self.n_admitted += 1
            out.append(req)
        return out

    def shed_expired(self, now: float) -> list:
        """Drop every queued request older than ``timeout``; returns (and
        records) their shed Responses."""
        if self.timeout is None:
            return []
        dropped = []
        for b, q in self._q.items():
            keep = deque()
            for req in q:
                if now - req.arrival > self.timeout:
                    dropped.append(self._shed_response(req, now))
                else:
                    keep.append(req)
            self._q[b] = keep
        self.shed.extend(dropped)
        return dropped

    def _pop_oldest(self, bucket: Optional[int] = None) -> Optional[Request]:
        """Oldest queued request — across buckets, or (grouped admission)
        from ``bucket`` only."""
        if bucket is not None:
            q = self._q.get(bucket)
            return q.popleft() if q else None
        best = None
        for b, q in self._q.items():
            if q and (best is None or q[0].arrival < self._q[best][0].arrival):
                best = b
        return self._q[best].popleft() if best is not None else None

    @staticmethod
    def _shed_response(req: Request, now: float) -> Response:
        # finished_at is the shed moment, so latency/queue_wait cover the
        # full time the request sat in the queue before being dropped
        return Response(id=req.id, prompt_len=req.prompt_len, tokens=(),
                        arrival=req.arrival, finished_at=float(now), shed=True)

    # ------------------------------------------------------------- state -----
    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def pending(self) -> list:
        """Queued requests, oldest first (diagnostic view)."""
        return sorted((r for q in self._q.values() for r in q),
                      key=lambda r: (r.arrival, r.id))
