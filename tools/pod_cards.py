#!/usr/bin/env python3
"""The federated client axis across cards: chip_smoke.py phase "pod"'s
cases over a world of ranks, one client a card, against the same cases
in one process.

    python3 tools/pod_cards.py [--world 2] [--smoke-world 4]
    python3 tools/pod_cards.py --device cpu --backend gloo    # rehearsal

(a) qwen1.5-4b at full width and 40 layers (``--smoke`` cuts it), K =
``--world``, `launch.train`'s defaults (batch 8, seq 128, lr 3e-3), the
embedding scaled, the cases chained (2 ERA rounds, a top-k 8 round, a
participation-0.5 sparse round, a FedAvg round) under
``fp32-deterministic``: first in this process on card 0, then over
``--world`` spawned ranks on cards 0 .. world - 1 over ``--backend``
(NCCL by default).  Every rank's lane must be bitwise the one-process
client's (`launch.pod_check.fingerprint`; FedAvg's mean only at two
ranks, beyond which the all-reduce's order is the backend's: its largest
relative difference of a leaf's float64 sum is printed).  (b) the same
at the smoke config with K = ``--smoke-world`` ranks, so that more ranks
than one card holds clients of the full model still cross.  Per case and rank: seconds
a round, peak memory, the collectives log's bytes by kind and the
kernels' launches, as one JSON line each; every card's ``nvidia-smi``
name and power limit first.  A mismatch exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CASES = ("era", "topk", "sparse", "fedavg")
PRESET = "fp32-deterministic"


def _cards() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def check(label, spec, backend) -> bool:
    """One-process cases, then the same over ``spec.clients`` ranks."""
    import torch

    from repro_torch.launch import dist, platform, pod_check
    from repro_torch.launch.roofline import cross_pod_bytes
    prev = platform.snapshot()
    platform.apply(PRESET)
    try:
        one = pod_check.run_cases(spec)
    finally:
        platform.restore(prev)
    if spec.device == "cuda":
        torch.cuda.empty_cache()
    ranks = dist.spawn(pod_check.rank_main, spec.clients,
                       dataclasses.replace(spec, preset=PRESET),
                       backend=backend)
    ok = True
    for case in spec.cases:
        rounds = {"era": 2}.get(case, 1)
        # FedAvg's all-reduce sums more than two ranks in the backend's
        # order: bitwise only at two (ROADMAP deviation 17)
        held = case != "fedavg" or spec.clients <= 2
        for r, rank in enumerate(ranks):
            rec = rank[case]
            same = rec["history"] == one[case]["history"] and all(
                rec["params"][leaf] == [lanes[r]]
                for leaf, lanes in one[case]["params"].items())
            ok &= same or not held
            spread = max(abs(rec["params"][leaf][0][1] - lanes[r][1])
                         / max(abs(lanes[r][1]), 1e-30)
                         for leaf, lanes in one[case]["params"].items())
            print(f"{label} rank {r} {case}: " + json.dumps(dict(
                bitwise=same, held_bitwise=held,
                leaf_sum_rel_diff=spread,
                seconds_a_round=rec["seconds"] / rounds,
                one_process_seconds_a_round=one[case]["seconds"] / rounds,
                peak_bytes=rec["peak_bytes"],
                cross_pod_bytes=cross_pod_bytes(rec["log"]),
                launches=rec["launches"])), flush=True)
    return ok


def main(argv=None) -> int:
    from repro_torch.launch.pod_check import DrillSpec
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--smoke-world", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="(a) at the smoke config too")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    args = ap.parse_args(argv)
    print(f"cards: {_cards()}", flush=True)
    base = dict(batch=8, seq=128, lr=3e-3, device=args.device,
                use_kernel=args.device == "cuda", scale_embedding=True,
                cases=CASES, chain=True, fingerprint=True)
    ok = check(f"pod cards (a) world {args.world}",
               DrillSpec(smoke=args.smoke, clients=args.world, **base),
               args.backend)
    ok &= check(f"pod cards (b) smoke world {args.smoke_world}",
                DrillSpec(clients=args.smoke_world, **base), args.backend)
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
