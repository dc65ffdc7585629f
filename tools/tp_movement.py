#!/usr/bin/env python3
"""How far one process's LLM rounds move each leaf, per learning rate: the
scale a held comparison's tolerance must stay under to see a round go
wrong (chip_smoke.py phase "tp", tools/pod_cards.py (d) and (e) hold
ranks to atol 1e-5 after one round and 1e-4 after two).

    python3 tools/tp_movement.py [--lrs 3e-3,3e-2] [--arch A --layers N]

phi3-medium-14b (or ``--arch``) at full width and 4 of its 40 layers (or
``--layers``; an encoder-decoder's encoder is cut with its decoder, as
the held runs' are) in float32 under ``fp32-deterministic``,
`launch.train`'s K = 2, batch 8, seq 128, the embedding scaled, on the
kernels: 2 ERA rounds, a top-k 8 round and a FedAvg round, each from the
keyed init.  One JSON line per
learning rate and case (the leaf that moved least, every leaf's largest
|after - before|, the losses, seconds and peak), the card's
``nvidia-smi`` name and power limit first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    import torch

    from repro_torch.launch import platform, pod_check
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", default="3e-3,3e-2")
    ap.add_argument("--arch", default="phi3-medium-14b")
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args(argv)
    print("card: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip(), flush=True)
    platform.apply("fp32-deterministic")
    for lr in (float(x) for x in args.lrs.split(",")):
        for case in ("era", "topk", "fedavg"):
            spec = pod_check.DrillSpec(
                arch=args.arch, smoke=False, n_layers=args.layers,
                clients=2, batch=8, seq=128, lr=lr, device="cuda",
                use_kernel=True, scale_embedding=True, fingerprint=True,
                overrides=(("dtype", "float32"),), cases=(case,))
            torch.cuda.reset_peak_memory_stats()
            rec = pod_check.run_cases(spec)[case]
            least = min(rec["moved"], key=rec["moved"].get)
            print(json.dumps(dict(
                arch=args.arch, layers=args.layers, lr=lr, case=case, least_moved_leaf=least,
                least_moved=rec["moved"][least], moved=rec["moved"],
                losses=[h["loss"] for h in rec["history"]],
                seconds=rec["seconds"],
                peak_bytes=torch.cuda.max_memory_allocated())), flush=True)
            del rec
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
