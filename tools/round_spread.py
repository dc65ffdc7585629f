#!/usr/bin/env python3
"""Where two runs of chip_smoke.py's phase-6 ERA round part, and why.

    python3 tools/round_spread.py [--variants JSON] [--no-update]

Runs the K=4 DS-FL ERA round of chip_smoke.py's phase 6 (the paper's MNIST
CNN at full width, ``build_image_task(1, K=4, n_private=800, n_open=400,
n_test=200, "non_iid")``, seeded weights and keyed draws, 1 local and 1
distillation epoch) once for each variant, a list of ``[device, dtype,
deterministic, use_kernel]`` (default: the card twice with torch's default
algorithms, the card with deterministic ones, the card with the plain
aggregation, the CPU in float32 and the CPU in float64).  For every pair it
prints the largest leaf difference, its share of chip_smoke.py's
card-vs-CPU limit (atol 2e-4 + rtol 1e-3 |x|) and, for the worst leaves,
the client lane each sits in.  Then, unless ``--no-update``, the first leg
alone (each client's local update) in float32 on each device the variants
name, against the CPU's float64 update, lane by lane, which shows how well
each client's update is conditioned there.

A CUDA variant needs a card; with CPU variants only it runs anywhere.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import chip_smoke as cs  # noqa: E402

DTYPES = {"float32": torch.float32, "float64": torch.float64}
DEFAULT = [["cuda", "float32", False, True], ["cuda", "float32", False, True],
           ["cuda", "float32", True, True], ["cuda", "float32", False, False],
           ["cpu", "float32", False, True], ["cpu", "float64", False, True]]
HP = dict(rounds=1, local_epochs=1, distill_epochs=1, batch_size=100,
          open_batch=200)


def setup(dtype):
    """Phase 6's task, models and draws, floating inputs in ``dtype``."""
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.data.pipeline import FederatedImageTask, build_image_task
    hp = DSFLConfig(**HP)
    t = build_image_task(1, K=4, n_private=800, n_open=400, n_test=200,
                         distribution="non_iid", hw=28, device="cpu")
    gen = torch.Generator().manual_seed(7)
    init = cs._paper_cnn("cpu")
    models = [tuple({k: v.to(dtype) for k, v in d.items()} for d in init(gen))
              for _ in range(5)]
    task = FederatedImageTask(t.x_clients.to(dtype), t.y_clients,
                              t.open_x.to(dtype), t.x_test.to(dtype),
                              t.y_test, t.n_classes)
    draws = cs._round_draws(7, 4, hp, t.x_clients.shape[1], 400, "cpu")
    return hp, task, models, draws


def run_round(device, dtype, det, use_kernel):
    """One ERA round; returns its leaves as float64 arrays by name."""
    from repro_torch import convert
    from repro_torch.core.algorithms import DSFLAlgorithm
    from repro_torch.core.engine import FedEngine
    from repro_torch.data.pipeline import FederatedImageTask
    from repro_torch.models.smallnets import apply_mnist_cnn
    hp, task, models, draws = setup(dtype)
    task = FederatedImageTask(*(x.to(device) for x in (
        task.x_clients, task.y_clients, task.open_x, task.x_test,
        task.y_test)), task.n_classes)
    mv = lambda d: {k: v.to(device) for k, v in d.items()}
    stack = lambda i: mv({k: torch.stack([m[i][k] for m in models[1:]])
                          for k in models[0][i]})
    algo = DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=use_kernel,
                         device=device)
    start = algo.init_from(stack(0), stack(1), mv(models[0][0]),
                           mv(models[0][1]))
    with cs.deterministic() if det else contextlib.nullcontext():
        state = FedEngine(algo).run(start, task, draws=[draws])
    st = convert.round_state_to_numpy(state)
    return {f"{part}.{field}.{k}": np.asarray(v, np.float64)
            for part in st for field in st[part]
            for k, v in convert.flatten_tree(st[part][field]).items()
            if np.asarray(v).size}


def compare(a, b, top=4):
    """The pair's largest difference, its share of the limit, the worst
    leaves (name, largest difference, client lane of the worst share)."""
    rows = []
    for k in b:
        d = np.abs(a[k] - b[k])
        share = d / (cs.CARD_VS_CPU_ATOL + cs.CARD_VS_CPU_RTOL * np.abs(b[k]))
        i = np.unravel_index(np.argmax(share), share.shape)
        lane = int(i[0]) if k.startswith("clients.") else None
        rows.append((float(share.max()), k, float(d.max()), lane))
    rows.sort(reverse=True)
    return dict(max_diff=max(r[2] for r in rows), share_of_limit=rows[0][0],
                worst=[dict(leaf=k, max_diff=d, share=s, lane=lane)
                       for s, k, d, lane in rows[:top]])


def update_spread(devices):
    """Each client's local update in float32 on each of ``devices``
    (deterministic algorithms) against the CPU's float64 update: the
    largest leaf difference per lane."""
    from repro_torch.core.algorithms import DSFLAlgorithm, lane_perms
    from repro_torch.core.client import local_update
    from repro_torch.core.engine import FedEngine
    from repro_torch.models.smallnets import apply_mnist_cnn

    def update(device, dtype):
        hp, task, models, draws = setup(dtype)
        mv = lambda d: {k: v.to(device) for k, v in d.items()}
        stack = lambda i: mv({k: torch.stack([m[i][k] for m in models[1:]])
                              for k in models[0][i]})
        algo = DSFLAlgorithm(apply_mnist_cnn, hp, device=device)
        st = algo.init_from(stack(0), stack(1), mv(models[0][0]),
                            mv(models[0][1]))
        ctx = FedEngine(algo).make_ctx(type(task)(*(x.to(device) for x in (
            task.x_clients, task.y_clients, task.open_x, task.x_test,
            task.y_test)), task.n_classes), o_idx=draws.o_idx.to(device))
        spec, _ = algo._specs()
        perms = lane_perms(spec, ctx.y.shape[1], ctx,
                           draws.update_perms.to(device), hp.seed, 0,
                           "update")
        with cs.deterministic():
            w, s, _, _ = local_update(spec, st.clients.params,
                                      st.clients.model_state,
                                      st.clients.opt_update, ctx.x, ctx.y,
                                      perms)
        return {k: v.cpu().double() for k, v in {**w, **s}.items()}

    exact = update("cpu", torch.float64)
    out = {}
    for device in devices:
        got, lanes = update(device, torch.float32), np.zeros(4)
        for k, v in exact.items():
            d = (got[k] - v).abs().reshape(4, -1).amax(1)
            lanes = np.maximum(lanes, d.numpy())
        out[device] = [float(x) for x in lanes]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=json.dumps(DEFAULT))
    ap.add_argument("--no-update", action="store_true")
    args = ap.parse_args()
    variants = [tuple(v) for v in json.loads(args.variants)]
    if any(v[0] == "cuda" for v in variants):
        smi = cs.phase_device()      # TF32 off, as in chip_smoke.py
        cs.phase_build()
    else:
        smi = "cpu"
    runs = []
    for v in variants:
        t0 = time.perf_counter()
        runs.append((v, run_round(v[0], DTYPES[v[1]], v[2], v[3])))
        print(f"ran {list(v)} in {time.perf_counter() - t0:.2f} s",
              flush=True)
    for (va, a), (vb, b) in itertools.combinations(runs, 2):
        print(json.dumps(dict(card=smi, a=list(va), b=list(vb),
                              **compare(a, b))), flush=True)
    if not args.no_update:
        devices = sorted({v[0] for v in variants})
        print(json.dumps(dict(card=smi, leg="local update, float32 on each "
                              "device vs the CPU's float64, per lane",
                              max_diff=update_spread(devices))))


if __name__ == "__main__":
    main()
