"""Export the port's JSONL traces (`repro_torch.obs.trace`) to
Chrome/Perfetto ``trace_event`` JSON, and validate them against the trace
schema (a host-only copy of ``repro/obs/perfetto.py``: the same input gives
the same output).

The exporter maps each span to a complete ("X") event and each instant to
an instant ("i") event; Perfetto nests same-tid "X" events by time
containment, which is exactly how the tracer's context-manager spans
relate.  Span categories become ``cat`` (Perfetto lets you filter on
them) and process metadata names the pid so the timeline reads "repro
<pid>" (the reference's name, so both converters agree) instead of a bare
number.  Open the output at
``https://ui.perfetto.dev`` (or ``chrome://tracing``).

CLI — convert, validate, and optionally assert layer coverage::

  PYTHONPATH=src python -m repro_torch.obs.perfetto run.jsonl run.perfetto.json \
      --require-layers engine,sim,wire

``--validate-only`` skips the conversion (CI uses it to check a trace
without keeping the converted artifact).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

_SPAN_KEYS = {"name", "cat", "ts_us", "dur_us", "pid", "tid"}
_INSTANT_KEYS = {"name", "cat", "ts_us", "pid", "tid"}


def read_trace(path: str) -> tuple:
    """(meta, records) from a JSONL trace; raises ValueError on malformed
    lines so a truncated/corrupt trace fails loudly."""
    meta, records = None, []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not JSON: {e}") from None
            if rec.get("type") == "meta":
                if meta is not None:
                    raise ValueError(f"{path}:{i + 1}: duplicate meta record")
                meta = rec
            else:
                records.append((i + 1, rec))
    return meta, records


def validate(path: str, require_layers: Optional[set] = None) -> dict:
    """Validate a JSONL trace against the schema: exactly one meta header
    carrying a provenance stamp (either package's: both have ``git_sha``),
    and every record a well-formed span or instant (required keys present,
    timestamps/durations numeric and non-negative).  Returns a summary dict (record counts, layers seen,
    provenance); raises ValueError naming the first offending line."""
    meta, records = read_trace(path)
    if meta is None:
        raise ValueError(f"{path}: no meta header record")
    prov = meta.get("provenance")
    if not isinstance(prov, dict) or "git_sha" not in prov:
        raise ValueError(f"{path}: meta record lacks a provenance stamp")
    layers, n_spans, n_instants = set(), 0, 0
    for lineno, rec in records:
        kind = rec.get("type")
        if kind == "span":
            need, n_spans = _SPAN_KEYS, n_spans + 1
        elif kind == "instant":
            need, n_instants = _INSTANT_KEYS, n_instants + 1
        else:
            raise ValueError(f"{path}:{lineno}: unknown record type {kind!r}")
        missing = need - rec.keys()
        if missing:
            raise ValueError(f"{path}:{lineno}: {kind} record missing "
                             f"{sorted(missing)}")
        for k in ("ts_us", "dur_us"):
            if k in need and (not isinstance(rec[k], (int, float))
                              or rec[k] < 0):
                raise ValueError(f"{path}:{lineno}: bad {k}: {rec[k]!r}")
        layers.add(rec["cat"])
    if require_layers:
        missing = set(require_layers) - layers
        if missing:
            raise ValueError(
                f"{path}: trace has spans from layers {sorted(layers)} but "
                f"is missing required layers {sorted(missing)}")
    return {"path": path, "spans": n_spans, "instants": n_instants,
            "layers": sorted(layers), "provenance": prov}


def to_perfetto(in_path: str, out_path: str) -> int:
    """Convert a JSONL trace to ``trace_event`` JSON; returns the number of
    events written.  The input is validated as a side effect (conversion
    reuses the same reader)."""
    meta, records = read_trace(in_path)
    events, pids = [], set()
    for _, rec in records:
        ev = {"name": rec["name"], "cat": rec.get("cat", "app"),
              "pid": rec["pid"], "tid": rec["tid"], "ts": rec["ts_us"]}
        if rec["type"] == "span":
            ev.update(ph="X", dur=rec["dur_us"])
        else:
            ev.update(ph="i", s="t")
        if rec.get("args"):
            ev["args"] = rec["args"]
        events.append(ev)
        pids.add(rec["pid"])
    for pid in sorted(pids):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": f"repro {pid}"}})
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    if meta is not None:
        doc["otherData"] = {"provenance": meta.get("provenance"),
                            "wall_iso": meta.get("wall_iso")}
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return len(events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace",
                    help="JSONL trace written by repro_torch.obs.Tracer")
    ap.add_argument("out", nargs="?", default=None,
                    help="output trace_event JSON (default: "
                         "<trace>.perfetto.json)")
    ap.add_argument("--require-layers", default=None,
                    help="comma-separated span categories that must appear "
                         "(e.g. engine,sim,wire) — exit 1 if any is missing")
    ap.add_argument("--validate-only", action="store_true",
                    help="validate the JSONL against the trace schema "
                         "without writing the converted file")
    args = ap.parse_args(argv)

    layers = (set(args.require_layers.split(","))
              if args.require_layers else None)
    summary = validate(args.trace, require_layers=layers)
    print(f"{args.trace}: {summary['spans']} spans, "
          f"{summary['instants']} instants, layers={summary['layers']}, "
          f"git={summary['provenance'].get('git_sha', '?')}")
    if not args.validate_only:
        out = args.out or args.trace + ".perfetto.json"
        n = to_perfetto(args.trace, out)
        print(f"wrote {out}: {n} trace events (open at ui.perfetto.dev)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
