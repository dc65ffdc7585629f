"""Host-side telemetry (mirrors ``repro/obs``): JSONL spans and instants
(`trace`) and counters, gauges and histograms (`metrics`), both zero-cost
when nothing is installed.  Nothing here runs on the device."""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry  # noqa
from .trace import (Tracer, current_registry, install,  # noqa
                    install_registry, instant, span, trace_to)
