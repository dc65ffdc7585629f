"""Host-side telemetry (mirrors ``repro/obs``): JSONL spans and instants
(`trace`) and counters, gauges and histograms (`metrics`), both zero-cost
when nothing is installed; the provenance stamp of a run (`provenance`);
the launchers' ``--trace``/``--metrics`` (`cli`); the Perfetto converter
(`perfetto`).  Nothing here runs on the device."""
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,  # noqa
                      percentile, percentiles)
from .provenance import RunProvenance  # noqa
from .trace import (Tracer, current_registry, install,  # noqa
                    install_registry, instant, span, trace_to)
