"""Shared ``--trace`` / ``--metrics`` wiring for the launch drivers (mirrors
``repro/obs/cli.py``).

Every entry point (``repro_torch.launch.train``, ``repro_torch.launch.serve``,
``examples/torch_sim_stragglers.py``) grows the same two flags through
`add_args` and wraps its run in `session`:

    obs_cli.add_args(ap)
    args = ap.parse_args(argv)
    with obs_cli.session(args):
        ...  # the run; instrumented code publishes on its own

With neither flag the session installs nothing, so the run takes the
disabled path (one global read a span).  With ``--trace out.jsonl`` a
`Tracer` with a provenance header is installed for the run; with
``--metrics out.json`` a `MetricsRegistry` is installed and its snapshot,
with the same provenance, is written on exit.  Convert a trace for the
Perfetto UI with ``python -m repro_torch.obs.perfetto out.jsonl out.json``.

The reference also starts its compile listener (``jit_watch``) under
``--trace``; the port has no compiles to count yet (no CUDA graphs are
captured on its paths), so it has no such listener.
"""
from __future__ import annotations

from typing import Optional


def add_args(ap) -> None:
    """Install the telemetry flags on an argparse parser."""
    ap.add_argument("--trace", default=None, metavar="OUT.jsonl",
                    help="write a structured JSONL span trace here "
                         "(convert with python -m repro_torch.obs.perfetto)")
    ap.add_argument("--metrics", default=None, metavar="OUT.json",
                    help="write a metrics snapshot (counters, gauges, "
                         "histograms and provenance) here on exit")


class session:
    """Context manager: install the tracer and registry ``args`` ask for,
    and on exit remove them and write their outputs (also after an
    exception, so a failed run still gets its partial trace)."""

    def __init__(self, args):
        self.trace_path: Optional[str] = getattr(args, "trace", None)
        self.metrics_path: Optional[str] = getattr(args, "metrics", None)
        self.device = getattr(args, "device", None)
        self._tracer = None
        self._registry = None
        self._prev_tracer = None
        self._prev_registry = None
        self._provenance = None

    def __enter__(self) -> "session":
        from . import trace as obs
        if self.trace_path or self.metrics_path:
            from .provenance import RunProvenance
            self._provenance = RunProvenance.collect(self.device).asdict()
        if self.trace_path:
            self._tracer = obs.Tracer(self.trace_path,
                                      provenance=self._provenance)
            self._prev_tracer = obs.install(self._tracer)
        if self.metrics_path:
            from .metrics import MetricsRegistry
            self._registry = MetricsRegistry()
            self._prev_registry = obs.install_registry(self._registry)
        return self

    def __exit__(self, *exc):
        from . import trace as obs
        if self._registry is not None:
            obs.install_registry(self._prev_registry)
            self._registry.to_json(self.metrics_path,
                                   provenance=self._provenance)
            print(f"metrics snapshot: {self.metrics_path}")
        if self._tracer is not None:
            obs.install(self._prev_tracer)
            self._tracer.close()
            print(f"trace: {self.trace_path} "
                  f"({self._tracer.n_records} records; view: python -m "
                  f"repro_torch.obs.perfetto {self.trace_path} out.json)")
        return False
