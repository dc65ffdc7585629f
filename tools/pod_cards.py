#!/usr/bin/env python3
"""The multi-device plane across cards: the federated client axis, one
client a card, and the dense family's tensor parallelism inside each
client, each against the same cases in one process.

    python3 tools/pod_cards.py [--world 2] [--smoke-world 4] [--parts abcdefghij]
    python3 tools/pod_cards.py --device cpu --backend gloo --smoke  # rehearsal

(a) qwen1.5-4b at full width and 40 layers (``--smoke`` cuts it), K =
``--world``, `launch.train`'s defaults (batch 8, seq 128, lr 3e-3), the
embedding scaled, the cases chained (2 ERA rounds, a top-k 8 round, a
participation-0.5 sparse round, a FedAvg round) under
``fp32-deterministic``: first in this process on card 0, then over
``--world`` spawned ranks on cards 0 .. world - 1 over ``--backend``
(NCCL by default).  Every rank's lane must be bitwise the one-process
client's (`launch.pod_check.fingerprint`).  (b) the same at the smoke
config with K = ``--smoke-world`` ranks, so that more ranks than one card
holds clients of the full model still cross; FedAvg's mean, whose
all-reduce sums more than two terms in the backend's order, is held on
its values instead: each rank's lane within 4 float32 ulps of each leaf's
largest magnitude, per leaf (`launch.pod_check.compare_slices`, the
one-process leaves shared with the ranks).

(c) phi3-medium-14b at full width and its 40 layers (``--smoke``: its
smoke config) over 4 ranks on the client mesh (2, 1, 2): one client a
"pod", each client's leaves split over a "model" axis of 2 (`launch.tp`),
K = 2, 2 ERA rounds then a FedAvg round, chained; seconds a round, peak
and bytes a rank by axis, held to `launch.tp.round_bytes`.  (d) the same
mesh at 4 of the 40 layers in float32 under ``fp32-deterministic`` at lr
3e-2 (HELD_LR), the 2
ERA rounds and the FedAvg round each from the init, every rank's slices
and losses held against the one-process run (atol 1e-4 after two rounds,
1e-5 after one, losses also rtol 1e-6), each one-process leaf shown to
move past that bound, and the check shown to fail on a FedAvg round with
one rank's ``w_down`` slice 1% off before it.  (e) as (d) for FSDP on the
mesh (2, 2, 1): one client a "pod", each client's leaves split over a
"data" axis of 2, each data rank on half the batch; 2 ERA rounds, a top-k
8 round and a FedAvg round.  (f) the dense family's decode step under
tensor parallelism (`launch.decode_check`) on (1, 1, 4) over the four
cards: phi3-medium-14b at full width and its 40 layers in bf16 (the
embedding scaled), whose 10 key/value heads do not split 4 ways, so
attention is replicated and the ring's window split over "model"; batch
8, a 512-token prompt fed through decode, then 32 greedy tokens: ms a
step, peak a rank, bytes a step by axis held to `launch.tp.decode_bytes`;
then the same at 4 layers in float32 held against one process on card 0
(tokens equal, logits within 1e-5 of the largest), and with rank 1's
value ring 1% off before a late step, which the check must fail.

(g) the Mamba2 mixer's tensor parallelism: mamba2-2.7b (80 heads of 64,
one group of B and C) on (2, 1, 2), one client a "pod", 40 heads a rank:
at full width and its 64 layers in bf16, 2 ERA rounds then a FedAvg
round, chained (timed; K5 on each rank's 40 heads, 64 a prediction); then
at 4 layers in float32 at lr 3e-1 (MAMBA_HELD_LR), held as (d), the
fault in the mixer's ``w_out``.
(h) expert parallelism: llama4-scout (16 experts of d_ff 8192, vocabulary
202,048) on (1, 1, 4), 4 experts a rank, at SCOUT_LAYERS of its 48 layers
in bf16, an ERA round then a FedAvg round, chained (timed); then one MoE
FFN at full width in float32 on 1,024 tokens in groups of 256, forward and
backward, each rank held to the same FFN whole in one process on its own
card (`launch.pod_check` `moe_ffn_rank`: within 1e-5 of each tensor's
largest magnitude, the dropped choices equal) and shown to fail with rank
1's expert ``w_down`` slice 1% off.
(i) the VLM: phi-3-vision-4.2b (32 heads of 96, 576 patches, vocabulary
32,064) on (2, 1, 2), one client a "pod", 16 heads a rank and the
projector's columns split: at full width and its 32 layers in bf16, 2 ERA
rounds then a FedAvg round, chained (timed); then at 4 layers in float32
at VLM_HELD_LR, held as (d), the fault in the projector ``patch_proj/w``.
(j) the encoder-decoder: whisper-small (12 heads of 64, 1,500 frames,
vocabulary 51,865 whole on "model") at full width and its 12 + 12 layers
in float32 on (1, 2, 2), tensor parallelism and FSDP together: 2 ERA
rounds, a top-k 8 round and a FedAvg round, each from the init, held as
(d) at WHISPER_HELD_LR (5e-1: at its full depth the cross-attention's
norm scale moves least), the fault in the decoder's ``dec/mlp/w_down``.
The kernels are built before any case.  Per case and rank one JSON line; every card's ``nvidia-smi`` name
and power limit first.  A mismatch exits 1.
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
ULPS = 4 * 2.0 ** -23
TP_ARCH, TP_SHAPE, TP_CASES = "phi3-medium-14b", (2, 1, 2), ("era", "fedavg")
TP_CHECK_LAYERS = 4
FSDP_SHAPE, FSDP_CASES = (2, 2, 1), ("era", "topk", "fedavg")
ROUND_TOL = {1: 1e-5, 2: 1e-4}
# the held runs' lr: every leaf must move past ROUND_TOL, which 3e-3 does
# not do at phi3-medium-14b's full width (tools/tp_movement.py)
HELD_LR = 3e-2
# the Mamba2 mixer's ``dt_bias`` and ``a_log`` move least: at 4 layers 2
# f32 ERA rounds move them past 1e-4 at 3e-1 (chip_smoke.py TP_LR)
MAMBA, MAMBA_SHAPE, MAMBA_HELD_LR = "mamba2-2.7b", (2, 1, 2), 3e-1
# scout on (1, 1, 4): the most layers at which a rank's DS-FL and FedAvg
# rounds, by `launch.dryrun`'s fake traces (13.2 / 31.4 GB at 1 / 4
# layers, +5.2 / +7.2 GB a layer), plus the drill's held input stack (3.1
# GB + 2.1 a layer) stay under 70 GB: 59.3 GB at 6
SCOUT, SCOUT_SHAPE, SCOUT_LAYERS = "llama4-scout-17b-a16e", (1, 1, 4), 6
MOE_RTOL = 1e-5
# the modality families: the least lr at which every leaf of the held
# cases moves past ROUND_TOL (tools/tp_movement.py): phi-3-vision at 4
# layers 3e-2; whisper at its 12 + 12 5e-1, where 2 f32 ERA rounds move
# ``dec/n2/scale`` 1.23e-4 (7.3e-5 at 3e-1, 1.7e-5 at 3e-2)
VLM, VLM_SHAPE, VLM_HELD_LR = "phi-3-vision-4.2b", (2, 1, 2), 3e-2
WHISPER, WHISPER_SHAPE = "whisper-small", (1, 2, 2)
WHISPER_CASES, WHISPER_HELD_LR = ("era", "topk", "fedavg"), 5e-1


def _cards() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def _one_process(spec):
    """The cases of ``spec`` in this process under the preset."""
    import torch

    from repro_torch.launch import platform, pod_check
    prev = platform.snapshot()
    platform.apply(PRESET)
    try:
        one = pod_check.run_cases(spec)
    finally:
        platform.restore(prev)
    if spec.device == "cuda":
        torch.cuda.empty_cache()
    return one


def _line(rec, rounds) -> dict:
    from repro_torch.launch.roofline import axis_bytes
    return dict(seconds_a_round=rec["seconds"] / rounds,
                peak_bytes=rec["peak_bytes"],
                bytes_by_axis=axis_bytes(rec["log"]),
                losses=[h["loss"] for h in rec["history"]],
                launches=rec["launches"])


def check(label, spec, backend) -> bool:
    """One-process cases, then the same over ``spec.clients`` ranks: every
    lane bitwise; beyond two ranks FedAvg's mean within 4 ulps a leaf."""
    from repro_torch.launch import dist, pod_check
    values = ("fedavg",) if spec.clients > 2 else ()
    one = _one_process(dataclasses.replace(spec, keep_values=values))
    compare = {c: one[c]["values"] for c in values}
    ranks = dist.spawn(pod_check.rank_main, spec.clients,
                       dataclasses.replace(spec, preset=PRESET), compare,
                       backend=backend)
    ok = True
    for case in spec.cases:
        rounds = {"era": 2}.get(case, 1)
        for r, rank in enumerate(ranks):
            rec = rank[case]
            same_hist = rec["history"] == one[case]["history"]
            if case in compare:
                # the all-reduce sums the terms in the backend's order
                worst = {leaf: d / max(rec["max_ref"][leaf], 1e-30)
                         for leaf, d in rec["max_abs"].items()}
                held = dict(within_4_ulps_a_leaf=all(
                    d <= ULPS * rec["max_ref"][leaf]
                    for leaf, d in rec["max_abs"].items()),
                    worst_leaf=max(worst, key=worst.get),
                    worst_in_ulps=max(worst.values()) / 2.0 ** -23)
                ok &= held["within_4_ulps_a_leaf"]
            else:
                held = dict(bitwise=same_hist and all(
                    rec["params"][leaf] == [lanes[r]]
                    for leaf, lanes in one[case]["params"].items()))
                ok &= held["bitwise"]
            print(f"{label} rank {r} {case}: " + json.dumps(dict(
                held, **_line(rec, rounds),
                one_process_seconds_a_round=one[case]["seconds"] / rounds)),
                flush=True)
    return ok


def tp_check(label, spec, backend, held: bool) -> bool:
    """The cases of ``spec`` over its mesh: bytes a rank by axis held to
    their closed form.  With ``held`` one case a spawn (the one-process
    leaves of a case stay on card 0 while the ranks run): each leaf of the
    one-process case moved past the tolerance, every rank's slices and
    losses held against the one-process run, and the FedAvg round run
    again with rank `FAULT_RANK`'s slice of `pod_check.fault_leaf` 1% off
    before it, which the check must fail."""
    from repro_torch.launch import dist, pod_check
    cfg = spec.config()
    world = 1
    for n in spec.mesh_shape:
        world *= n
    ok = True
    for cases in ([(c,) for c in spec.cases] if held else [spec.cases]):
        runs = [dataclasses.replace(spec, cases=cases)]
        compares, one = [None], {}
        if held:
            one = _one_process(dataclasses.replace(runs[0],
                                                   keep_values=cases))
            compares = [{c: one[c].pop("values") for c in cases}]
            if cases == ("fedavg",):
                runs.append(dataclasses.replace(runs[0], fault=True))
                compares.append(compares[0])
        ranks = dist.spawn(pod_check.rank_main_many, world, tuple(runs),
                           tuple(compares), backend=backend)
        del compares
        if spec.device == "cuda":
            import torch
            # the spawn's shared leaves are freed once the ranks let them go
            torch.cuda.ipc_collect()
            torch.cuda.empty_cache()
        for i, run in enumerate(runs):
            ok &= _tp_lines(label, cfg, run, [rk[i] for rk in ranks], one)
    return ok


def _tp_lines(label, cfg, spec, rank_recs, one) -> bool:
    """One JSON line per case and rank of one run (see `tp_check`)."""
    from repro_torch.launch import pod_check, tp
    ok = True
    fault_leaf = pod_check.fault_leaf(cfg)
    for case in spec.cases:
        kind, rounds, _, hp_kw, _, _ = pod_check.CASES[case]
        want = tp.merge((tp.round_bytes(
            cfg, spec.mesh_shape, clients=spec.clients, batch=spec.batch,
            seq=spec.seq, mode=kind, topk=hp_kw.get("topk"),
            lanes_run=spec.clients // spec.mesh_shape[0]), rounds))
        tol, worst = ROUND_TOL[rounds], []
        for r, rec in enumerate(rank_recs):
            rec = rec[case]
            line = _line(rec, rounds)
            res = dict(bytes_closed_form=line["bytes_by_axis"] == want)
            ok &= res["bytes_closed_form"]
            if case in one:
                ref = one[case]
                moved = ref["moved"]
                least = min(moved, key=moved.get)
                leaf = max(rec["max_abs"], key=rec["max_abs"].get)
                worst.append(rec["max_abs"][leaf])
                ref_losses = [h["loss"] for h in ref["history"]]
                res.update(
                    tol=tol, worst_leaf=leaf, max_abs=rec["max_abs"][leaf],
                    fault_leaf=fault_leaf,
                    fault_leaf_max_abs=rec["max_abs"][fault_leaf],
                    least_moved_leaf=least, least_moved=moved[least],
                    every_leaf_moved_past_tol=moved[least] > tol,
                    one_process_losses=ref_losses,
                    one_process_seconds_a_round=ref["seconds"] / rounds)
                ok &= res["every_leaf_moved_past_tol"]
                if not spec.fault:
                    res.update(within_tol=res["max_abs"] <= tol,
                               losses_within_tol=len(ref_losses) == len(
                                   line["losses"]) and all(
                                   abs(a - b) <= tol + 1e-6 * abs(b)
                                   for a, b in zip(line["losses"],
                                                   ref_losses)))
                    ok &= res["within_tol"] and res["losses_within_tol"]
            print(f"{label}{' fault' if spec.fault else ''} rank {r} {case}: "
                  + json.dumps(dict(res, **line)), flush=True)
        if spec.fault:
            caught = bool(worst) and max(worst) > tol
            print(f"{label} fault {case}: rank {pod_check.FAULT_RANK}'s "
                  f"{fault_leaf} slice 1% off before the round "
                  f"{'fails' if caught else 'PASSES'} the check", flush=True)
            ok &= caught
    return ok


DECODE_SHAPE, DECODE_BATCH, DECODE_PROMPT, DECODE_STEPS = (1, 1, 4), 8, 512, 32
DECODE_RTOL = 1e-5


def decode_check(label, smoke: bool, device: str, backend: str) -> bool:
    """Case (f): see the module's docstring."""
    import dataclasses as dc_

    from repro_torch.launch import decode_check as dc
    from repro_torch.launch import dist, tp
    over = (("n_heads", 8), ("n_kv_heads", 2)) if smoke else ()
    timed = dc.DecodeSpec(arch=TP_ARCH, smoke=smoke, overrides=over,
                          mesh_shape=DECODE_SHAPE, batch=DECODE_BATCH,
                          prompt=DECODE_PROMPT, steps=DECODE_STEPS,
                          scale_embedding=True)
    held = dc_.replace(timed, n_layers=None if smoke else TP_CHECK_LAYERS,
                       overrides=over + (("dtype", "float32"),))
    params = dc.init_params(held, device)
    one = dc.greedy(held, params, device)
    del params
    world = 1
    for n in DECODE_SHAPE:
        world *= n
    runs = (timed, held, dc_.replace(held, fault="ring"))
    ranks = dist.spawn(dc.rank_main, world, runs, device, backend=backend)
    ok = True
    for i, spec in enumerate(runs):
        want = tp.decode_bytes(spec.config(), DECODE_SHAPE, batch=spec.batch,
                               window=spec.seq_len)
        checks = []
        for r, rk in enumerate(ranks):
            rec = rk[i]
            ms = sorted(rec["ms_a_step"])
            line = dict(ms_a_step_median=ms[len(ms) // 2],
                        ms_a_step_min=ms[0], ms_a_step_max=ms[-1],
                        steps_timed=len(ms), peak_bytes=rec["peak_bytes"],
                        step_bytes=rec["step_bytes"],
                        bytes_closed_form=rec["step_bytes"] == want)
            ok &= line["bytes_closed_form"]
            if spec is not timed:
                checks.append(dc.compare(rec, one, DECODE_RTOL))
                line.update(checks[-1])
                if spec.fault is None:
                    ok &= checks[-1]["ok"]

            cfg = spec.config()
            kind = (f"{'fault' if spec.fault else 'timed' if spec is timed else 'held'}"
                    f" {cfg.dtype} {cfg.n_layers} layers")
            print(f"{label} {kind} rank {r}: " + json.dumps(line), flush=True)
        if spec.fault is not None:
            caught = not all(c["ok"] for c in checks)
            print(f"{label}: rank 1's value ring 1% off "
                  f"{'fails' if caught else 'PASSES'} the check", flush=True)
            ok &= caught
    return ok


def moe_check(label, smoke: bool, device: str, backend: str) -> bool:
    """Case (h)'s MoE FFN: see the module's docstring."""
    from repro_torch.launch import dist, pod_check
    from repro_torch.launch.roofline import axis_bytes
    spec = pod_check.MoEFFNSpec(arch=SCOUT, smoke=smoke, device=device,
                                mesh_shape=SCOUT_SHAPE,
                                **({"tokens": 64, "group": 16} if smoke
                                   else {}))
    world = 1
    for n in SCOUT_SHAPE:
        world *= n
    recs = dist.spawn(dist.rank_programs, world, tuple(
        (pod_check.moe_ffn_rank, (dataclasses.replace(spec, fault=f),))
        for f in (False, True)), backend=backend)
    ok = True
    for i, role in enumerate(("held", "fault")):
        rel = []
        for r, rk in enumerate(recs):
            got = rk[i]
            worst = max(got["max_abs"], key=lambda k: got["max_abs"][k]
                        / max(got["max_ref"][k], 1e-30))
            rel.append(got["max_abs"][worst] / got["max_ref"][worst])
            line = dict(experts_a_rank=got["experts"], seconds=got["seconds"],
                        one_process_seconds=got["one_process_seconds"],
                        dropped=got["dropped"],
                        dropped_equal=got["dropped"]
                        == got["one_process_dropped"],
                        bytes_by_axis=axis_bytes(got["log"]), worst=worst,
                        rel_err=rel[-1], rtol=MOE_RTOL)
            ok &= line["dropped_equal"]
            if role == "held":
                line["within_rtol"] = rel[-1] <= MOE_RTOL
                ok &= line["within_rtol"]
            print(f"{label} {role} rank {r}: " + json.dumps(line),
                  flush=True)
        if role == "fault":
            caught = max(rel) > MOE_RTOL
            print(f"{label}: rank 1's expert w_down slice 1% off "
                  f"{'fails' if caught else 'PASSES'} the check", flush=True)
            ok &= caught
    return ok


def main(argv=None) -> int:
    from repro_torch.launch.pod_check import DrillSpec
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--smoke-world", type=int, default=4)
    ap.add_argument("--smoke", action="store_true",
                    help="every part at the smoke configs (a rehearsal)")
    ap.add_argument("--parts", default="abcdefghij")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    args = ap.parse_args(argv)
    print(f"cards: {_cards()}", flush=True)
    if args.device == "cuda":
        # built before any case, so no case's first round holds nvcc
        import time

        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build()
        print(f"kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    base = dict(batch=8, seq=128, lr=3e-3, device=args.device,
                use_kernel=args.device == "cuda", scale_embedding=True,
                fingerprint=True)
    ok = True
    if "a" in args.parts:
        ok &= check(f"pod cards (a) world {args.world}",
                    DrillSpec(smoke=args.smoke, clients=args.world,
                              cases=CASES, chain=True, **base), args.backend)
    if "b" in args.parts:
        ok &= check(f"pod cards (b) smoke world {args.smoke_world}",
                    DrillSpec(clients=args.smoke_world, cases=CASES,
                              chain=True, **base), args.backend)
    tp_base = dict(base, arch=TP_ARCH, smoke=args.smoke, clients=2,
                   mesh_shape=TP_SHAPE, cases=TP_CASES)
    if "c" in args.parts:
        ok &= tp_check(f"tp cards (c) {TP_ARCH} {TP_SHAPE}",
                       DrillSpec(chain=True, **tp_base), args.backend, False)
    f32 = dict(tp_base, n_layers=None if args.smoke else TP_CHECK_LAYERS,
               overrides=(("dtype", "float32"),), preset=PRESET,
               lr=HELD_LR)
    if "d" in args.parts:
        ok &= tp_check(f"tp cards (d) {TP_ARCH} {TP_SHAPE} f32",
                       DrillSpec(**f32), args.backend, True)
    if "e" in args.parts:
        ok &= tp_check(f"tp cards (e) {TP_ARCH} {FSDP_SHAPE} f32",
                       DrillSpec(**dict(f32, mesh_shape=FSDP_SHAPE,
                                        cases=FSDP_CASES)),
                       args.backend, True)
    if "f" in args.parts:
        ok &= decode_check(f"tp cards (f) {TP_ARCH} {DECODE_SHAPE} decode",
                           args.smoke, args.device, args.backend)
    if "g" in args.parts:
        mamba = dict(tp_base, arch=MAMBA, mesh_shape=MAMBA_SHAPE)
        ok &= tp_check(f"tp cards (g) {MAMBA} {MAMBA_SHAPE}",
                       DrillSpec(chain=True, **mamba), args.backend, False)
        ok &= tp_check(f"tp cards (g) {MAMBA} {MAMBA_SHAPE} f32",
                       DrillSpec(**dict(f32, arch=MAMBA,
                                        mesh_shape=MAMBA_SHAPE,
                                        lr=MAMBA_HELD_LR)),
                       args.backend, True)
    if "h" in args.parts:
        scout = dict(tp_base, arch=SCOUT, mesh_shape=SCOUT_SHAPE,
                     n_layers=None if args.smoke else SCOUT_LAYERS)
        ok &= tp_check(f"tp cards (h) {SCOUT} {SCOUT_SHAPE} "
                       f"{scout['n_layers'] or 'smoke'} layers",
                       DrillSpec(chain=True, **scout), args.backend, False)
        ok &= moe_check(f"tp cards (h) {SCOUT} {SCOUT_SHAPE} moe ffn f32",
                        args.smoke, args.device, args.backend)
    if "i" in args.parts:
        vlm = dict(tp_base, arch=VLM, mesh_shape=VLM_SHAPE)
        ok &= tp_check(f"tp cards (i) {VLM} {VLM_SHAPE}",
                       DrillSpec(chain=True, **vlm), args.backend, False)
        ok &= tp_check(f"tp cards (i) {VLM} {VLM_SHAPE} f32",
                       DrillSpec(**dict(f32, arch=VLM, mesh_shape=VLM_SHAPE,
                                        lr=VLM_HELD_LR)),
                       args.backend, True)
    if "j" in args.parts:
        ok &= tp_check(f"tp cards (j) {WHISPER} {WHISPER_SHAPE} f32",
                       DrillSpec(**dict(f32, arch=WHISPER, n_layers=None,
                                        mesh_shape=WHISPER_SHAPE,
                                        cases=WHISPER_CASES,
                                        lr=WHISPER_HELD_LR)),
                       args.backend, True)
    print(json.dumps({"ok": bool(ok)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
