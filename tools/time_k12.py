#!/usr/bin/env python3
"""Time K1/K2 (the ERA kernels) of one source tree on one card, hot and cold.

    python3 tools/time_k12.py [--src DIR]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds its ``csrc/era_sharpen.cu`` into that tree's build directory, and at
each of chip_smoke.py's ``ERA_SHAPES`` ((100, 1000, 10), (100, 1000, 46) and
(10, 256, 32768) f32) checks K1, K2 and K2's weighted mean against their
plain versions (atol 1e-6) and times them as chip_smoke.py's phase 4 does:
stream-timed ``ms``, ``graph_ms`` (a CUDA graph of 100 launches on one
input, which stays in the L2 cache: hot) and ``graph_cold_ms`` (the graph
cycling over copies larger together than the L2 cache: cold), with the
weighted mean's ``torch.mv`` yardstick.  Prints one JSON line per shape: the
tree, the card (``nvidia-smi`` name and power limit) and the times.

The timing code is chip_smoke.py's, from this checkout, so two trees are
timed alike.  To compare them, run both in one call on one card, in turns,
e.g. old, new, new, old; each run is its own process, so both trees'
modules keep their names.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs          # imports torch only; puts ROOT/src on the path
    sys.path.insert(0, str(src))     # ahead of it: the tree under test
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_k12: needs an NVIDIA GPU")
    from repro_torch.kernels import _build
    from repro_torch.kernels import era_sharpen as es
    if not Path(es.__file__).resolve().is_relative_to(src):
        sys.exit(f"time_k12: imported {es.__file__}, not from {src}")
    for line in _build.build(("era_sharpen",)).get("era_sharpen",
                                                   "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"ptxas {line.strip()}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    keys = ("ms", "graph_ms", "graph_cold_ms", "bound_ms", "max_abs_err",
            "library_ms", "library_graph_ms", "library_graph_cold_ms",
            "fill_graph_ms")
    for i, shape in enumerate(cs.ERA_SHAPES):
        rows = cs.era_timing(es, *shape, seed=1 + i)
        print(json.dumps({"src": str(src), "device": smi, "shape": list(shape),
                          **{name: {k: r[k] for k in keys if k in r}
                             for name, r in rows.items()}}), flush=True)


if __name__ == "__main__":
    main()
