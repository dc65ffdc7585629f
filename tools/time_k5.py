#!/usr/bin/env python3
"""Time K5 (the SSD within-chunk kernel) of one source tree on one card.

    python3 tools/time_k5.py [--src DIR] [--iters N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds its ``csrc/ssd_chunk.cu`` into that tree's build directory, checks
the kernel against its plain version at the (4, 2048) prefill's shape of
mamba2-2.7b, (M, Q, H, P, G, N) = (32, 256, 80, 64, 1, 128), atol = rtol =
1e-4, and times it with CUDA events over ``N`` launches after a warm-up.
Then it draws B and C unit-normal (scores of std sqrt(N)) and measures the
kernel's and the plain version's largest error against float64.  Prints one
JSON line: the tree, the card (``nvidia-smi`` name and power limit), ms per
launch, the largest difference from the plain version, both float64 errors.

To compare two versions, run them in one call on one card, in turns, e.g.
old, new, new, old; each run is its own process, so both trees' modules
keep their names.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (32, 256, 80, 64, 1, 128)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_k5: needs an NVIDIA GPU")
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_chunk as ssd
    for line in _build.build(("ssd_chunk",)).get("ssd_chunk", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"ptxas {line.strip()}", flush=True)
    if not Path(ssd.__file__).resolve().is_relative_to(src):
        sys.exit(f"time_k5: imported {ssd.__file__}, not from {src}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    inputs = draw(20, SHAPE[5] ** -0.25)
    y = ssd.ssd_chunk(*inputs)
    exp = ssd.ssd_chunk_plain(*inputs)
    torch.cuda.synchronize()
    err = float((y - exp).abs().max())
    if not torch.allclose(y, exp, atol=1e-4, rtol=1e-4):
        sys.exit(f"time_k5: {src} disagrees with its plain version ({err})")
    for _ in range(10):
        ssd.ssd_chunk(*inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.iters):
        ssd.ssd_chunk(*inputs)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / args.iters
    raw = draw(21, 1.0)
    exact = float64(*raw)
    e_k = float((ssd.ssd_chunk(*raw).double() - exact).abs().max())
    e_p = float((ssd.ssd_chunk_plain(*raw).double() - exact).abs().max())
    print(json.dumps({"src": str(src), "device": smi, "shape": list(SHAPE),
                      "ms": ms, "iters": args.iters, "max_abs_err": err,
                      "float64_err": e_k, "float64_err_plain": e_p}),
          flush=True)


def draw(seed, bc_scale):
    """K5's inputs at SHAPE on the card, as chip_smoke.py draws them."""
    import torch
    M, Q, H, P, G, N = SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")
    x = rn(M, Q, H, P)
    dt = torch.nn.functional.softplus(rn(M, Q, H))
    return x, dt, -0.3 * dt, rn(M, Q, G, N) * bc_scale, \
        rn(M, Q, G, N) * bc_scale


def float64(x, dt, dA, Bm, Cm):
    """K5's function in float64, head by head."""
    import torch
    x, dt, dA, Bm, Cm = (t.double() for t in (x, dt, dA, Bm, Cm))
    H, G, Q = x.shape[2], Bm.shape[2], x.shape[1]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    y = torch.empty_like(x)
    for h in range(H):
        g = h // (H // G)
        cum = torch.cumsum(dA[:, :, h], dim=1)
        L = torch.exp((cum[:, :, None] - cum[:, None, :]).masked_fill(
            ~causal, float("-inf")))
        W = torch.einsum("mqn,mkn->mqk", Cm[:, :, g], Bm[:, :, g]) * L \
            * dt[:, None, :, h]
        y[:, :, h] = torch.einsum("mqk,mkp->mqp", W, x[:, :, h])
    return y


if __name__ == "__main__":
    main()
