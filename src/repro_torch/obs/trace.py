"""Structured JSONL tracing: spans, instants, and the global install point
(a host-only copy of the parts of ``repro/obs/trace.py`` the port uses;
the compile listener is left out).

A `Tracer` appends one JSON object per line to a file:

* header (first line): ``{"type": "meta", "clock": "perf_counter_ns",
  "t0_ns": ..., "wall_iso": ..., "provenance": {...}}`` (`RunProvenance`).
* spans: ``{"type": "span", "name", "cat", "ts_us", "dur_us", "pid",
  "tid", "args"}`` — closed intervals, written at span exit.  Timestamps
  are microseconds of monotonic host time since the header's ``t0_ns``,
  so records are orderable within a run and nest by containment (which is
  exactly how Perfetto renders same-tid "X" events).
* instants: same shape, no ``dur_us``.

Nothing here touches the device: spans measure *host-visible* phases (a
span around a chunk covers dispatch through its one host sync, which is
the number training actually waits on).  Instrumented code calls the
module-level ``span``/``instant`` helpers, which hit the process-global
tracer installed by ``install``/``trace_to``; with none installed they
return a shared no-op context manager: one global read, zero allocation,
no timestamps taken.
"""
from __future__ import annotations

import datetime
import json
import os
import threading
import time
from typing import Optional

class _NullSpan:
    """The disabled path: a reusable, stateless no-op context manager."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):            # parity with _Span.set
        return self


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("tracer", "name", "cat", "args", "t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0

    def set(self, **args):
        """Attach result attributes discovered inside the span."""
        self.args.update(args)
        return self

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.tracer._write_span(self.name, self.cat, self.t0, t1, self.args)
        return False


class Tracer:
    """JSONL span/event writer.  One per output file; cheap enough to wrap
    every host-side phase of a run (a span costs two ``perf_counter_ns``
    reads and one buffered ``json.dumps`` line)."""

    def __init__(self, path: str, provenance: Optional[dict] = None,
                 buffer_lines: int = 256):
        self.path = path
        self._f = open(path, "w")
        self._lock = threading.Lock()
        self._buf: list = []
        self._buffer_lines = int(buffer_lines)
        self.t0_ns = time.perf_counter_ns()
        self.n_records = 0
        if provenance is None:
            from .provenance import RunProvenance
            provenance = RunProvenance.collect().asdict()
        self._emit({"type": "meta", "clock": "perf_counter_ns",
                    "t0_ns": self.t0_ns,
                    "wall_iso": datetime.datetime.now(
                        datetime.timezone.utc).isoformat(),
                    "provenance": provenance})

    # ------------------------------------------------------------ writing ----
    def _emit(self, rec: dict) -> None:
        line = json.dumps(rec, default=str)
        with self._lock:
            self._buf.append(line)
            self.n_records += 1
            if len(self._buf) >= self._buffer_lines:
                self._flush_locked()

    def _flush_locked(self) -> None:
        if self._buf:
            self._f.write("\n".join(self._buf) + "\n")
            self._buf = []

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            if not self._f.closed:
                self._f.close()

    def _us(self, t_ns: int) -> float:
        return (t_ns - self.t0_ns) / 1e3

    def _write_span(self, name, cat, t0_ns, t1_ns, args) -> None:
        self._emit({"type": "span", "name": name, "cat": cat,
                    "ts_us": self._us(t0_ns),
                    "dur_us": (t1_ns - t0_ns) / 1e3,
                    "pid": os.getpid(),
                    "tid": threading.get_native_id(),
                    **({"args": args} if args else {})})

    # --------------------------------------------------------------- API -----
    def span(self, name: str, cat: str = "app", **args) -> _Span:
        """``with tracer.span("engine.chunk", "engine", rounds=k): ...``"""
        return _Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "app", **args) -> None:
        t = time.perf_counter_ns()
        self._emit({"type": "instant", "name": name, "cat": cat,
                    "ts_us": self._us(t), "pid": os.getpid(),
                    "tid": threading.get_native_id(),
                    **({"args": args} if args else {})})


# ------------------------------------------------------------ global plane ---
_TRACER: Optional[Tracer] = None
_REGISTRY = None                      # Optional[MetricsRegistry]


def install(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Make ``tracer`` the process-global tracer (None disables tracing);
    returns the previous one so callers can restore it."""
    global _TRACER
    prev, _TRACER = _TRACER, tracer
    return prev


def span(name: str, cat: str = "app", **args):
    """The library-side entry point: a real span when tracing is on, the
    shared no-op otherwise."""
    t = _TRACER
    return _NULL_SPAN if t is None else t.span(name, cat, **args)


def instant(name: str, cat: str = "app", **args) -> None:
    t = _TRACER
    if t is not None:
        t.instant(name, cat, **args)


class trace_to:
    """``with obs.trace_to("run.jsonl") as t: ...`` — scoped tracing that
    restores whatever tracer (usually none) was installed before."""

    def __init__(self, path: str):
        self.path = path
        self.tracer: Optional[Tracer] = None
        self._prev: Optional[Tracer] = None

    def __enter__(self) -> Tracer:
        self.tracer = Tracer(self.path)
        self._prev = install(self.tracer)
        return self.tracer

    def __exit__(self, *exc):
        install(self._prev)
        self.tracer.close()
        return False


# ------------------------------------------------------- metrics registry ----
def install_registry(registry) -> object:
    """Install a `MetricsRegistry` as the process-global publish target
    (None disables publishing); returns the previous one."""
    global _REGISTRY
    prev, _REGISTRY = _REGISTRY, registry
    return prev


def current_registry():
    """The installed `MetricsRegistry`, or None.  Library code reads this
    once per host-side phase (chunk / round / serve step) and skips
    publishing when it is None — the disabled path is one global read."""
    return _REGISTRY
