#!/usr/bin/env python3
"""Time one kernel family of one source tree on one card.

    python3 tools/time_kernel.py --kernel {k12,k3,k5} [--src DIR] [--iters N]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds the family's CUDA source into that tree's build directory (printing
ptxas's register and spill lines), checks the kernels against their plain
versions and times them.  Prints one JSON line per shape: the tree, the
card (``nvidia-smi`` name and power limit) and the numbers.

- ``k12``: K1, K2 and K2's weighted mean (``csrc/era_sharpen.cu``) at
  chip_smoke.py's ``ERA_SHAPES``, by its ``era_timing``: stream-timed
  ``ms``, ``graph_ms`` (a CUDA graph of 100 launches on one input, which
  stays in the L2 cache: hot) and ``graph_cold_ms`` (the graph cycling
  over copies larger together than the L2 cache: cold), with the weighted
  mean's ``torch.mv`` yardstick.
- ``k3``: K3 (``csrc/distill_loss.cu``) at chip_smoke.py's ``K3_SHAPES``,
  by its ``k3_timing``: the same three times, ``F.cross_entropy(z, t,
  reduction="none")`` timed the same ways, K3's and the plain version's
  error against float64; then the peak memory of the autograd route
  (``ops.distill_loss_2d``: K3 forward, K4 backward) at the last shape.
- ``k5``: K5 (``csrc/ssd_chunk.cu``) at the (4, 2048) prefill's shape of
  mamba2-2.7b, (M, Q, H, P, G, N) = (32, 256, 80, 64, 1, 128), checked at
  atol = rtol = 1e-4 and timed with CUDA events over ``--iters`` launches
  after a warm-up; then, with B and C unit-normal, K5's and the plain
  version's largest error against float64.

The timing code is this checkout's, so two trees are timed alike.  To
compare them, run both in one call on one card, in turns, e.g. old, new,
new, old; each run is its own process, so both trees' modules keep their
names.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MODULES = {"k12": "era_sharpen", "k3": "distill_loss", "k5": "ssd_chunk"}
K5_SHAPE = (32, 256, 80, 64, 1, 128)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", required=True, choices=MODULES)
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--iters", type=int, default=200,
                    help="K5's timed launches")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs          # puts ROOT/src on the path
    # chip_smoke imported this tree's repro_torch for its roofline; the
    # kernel under test comes from --src, imported afresh
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(src))     # ahead of it: the tree under test
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_kernel: needs an NVIDIA GPU")
    from repro_torch.kernels import _build
    name = MODULES[args.kernel]
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    if not Path(mod.__file__).resolve().is_relative_to(src):
        sys.exit(f"time_kernel: imported {mod.__file__}, not from {src}")
    for line in _build.build((name,)).get(name, "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"ptxas {line.strip()}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    timer = {"k12": time_k12, "k3": time_k3, "k5": time_k5}[args.kernel]
    for row in timer(cs, mod, args):
        print(json.dumps({"src": str(src), "device": smi, **row}), flush=True)


def time_k12(cs, es, args):
    keys = ("ms", "graph_ms", "graph_cold_ms", "bound_ms", "max_abs_err",
            "library_ms", "library_graph_ms", "library_graph_cold_ms",
            "fill_graph_ms")
    for i, shape in enumerate(cs.ERA_SHAPES):
        rows = cs.era_timing(es, *shape, seed=1 + i)
        yield {"shape": list(shape),
               **{name: {k: r[k] for k in keys if k in r}
                  for name, r in rows.items()}}


def time_k3(cs, dl, args):
    import torch
    from repro_torch.kernels import ops
    keys = ("ms", "graph_ms", "graph_cold_ms", "bound_ms", "max_abs_err",
            "plain_ms", "library_ms", "library_graph_ms",
            "library_graph_cold_ms", "cold_copies", "plan", "float64_err",
            "plain_float64_err")
    for i, (N, V, dtype) in enumerate(cs.K3_SHAPES):
        atol = 1e-4 if dtype == torch.float32 else 2e-2
        rec, inputs = cs.k3_timing(dl, N, V, dtype, 5 + i, atol)
        del inputs
        torch.cuda.empty_cache()
        yield {"shape": [N, V], "dtype": rec["dtype"],
               "distill_loss_fwd": {k: rec[k] for k in keys}}
    N, V, dtype = cs.K3_SHAPES[-1]
    z, t = cs._zt(N, V, 9, dtype)
    yield {"shape": [N, V], "dtype": str(dtype).replace("torch.", ""),
           "autograd_peak_bytes": cs.distill_autograd_peak(ops, z, t)}


def time_k5(cs, ssd, args):
    import torch
    inputs = k5_draw(20, K5_SHAPE[5] ** -0.25)
    y = ssd.ssd_chunk(*inputs)
    exp = ssd.ssd_chunk_plain(*inputs)
    torch.cuda.synchronize()
    err = float((y - exp).abs().max())
    if not torch.allclose(y, exp, atol=1e-4, rtol=1e-4):
        sys.exit(f"time_kernel: K5 disagrees with its plain version ({err})")
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
    raw = k5_draw(21, 1.0)
    exact = k5_float64(*raw)
    e_k = float((ssd.ssd_chunk(*raw).double() - exact).abs().max())
    e_p = float((ssd.ssd_chunk_plain(*raw).double() - exact).abs().max())
    yield {"shape": list(K5_SHAPE), "ms": ms, "iters": args.iters,
           "max_abs_err": err, "float64_err": e_k, "float64_err_plain": e_p}


def k5_draw(seed, bc_scale):
    """K5's inputs at K5_SHAPE on the card, as chip_smoke.py draws them."""
    import torch
    M, Q, H, P, G, N = K5_SHAPE
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")
    x = rn(M, Q, H, P)
    dt = torch.nn.functional.softplus(rn(M, Q, H))
    return x, dt, -0.3 * dt, rn(M, Q, G, N) * bc_scale, \
        rn(M, Q, G, N) * bc_scale


def k5_float64(x, dt, dA, Bm, Cm):
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
