#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py          # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero and prints no result:

 1. device   the card's name and power limit, torch and CUDA versions; TF32
             off for matmuls and convolutions, so float32 means float32.
 2. build    the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
             one process per source), timed, with ptxas's report.
 3. kernels  each kernel against its plain PyTorch version on the card:
             K1/K2 (ERA, weighted ERA) at the round's (100, 1000, 10) f32,
             at (3, 13, 151) bf16 and the zero-weight bitwise check; K3/K4
             (distillation loss and gradient) at the round's distillation
             batch (100, 10) f32, at a ragged f32 shape and at (2048,
             151936) bf16 (the vocabulary of configs/qwen1_5_4b.py).
 4. timing   CUDA events over >= 100 launches after a warm-up, for each
             kernel and its plain version; the bound is the larger of the
             bytes moved over 3.35 TB/s and the fp32 operations over 67
             TFLOP/s (H100 SXM data sheet); for K3 also the library call
             ``F.cross_entropy(z, t, reduction="none")`` as a yardstick.
 5. slice    the main path: DS-FL (paper Algorithm 1) through
             ``FedEngine.run`` with ``DSFLAlgorithm(use_kernel=True)``, the
             paper's MNIST CNN at full width (582,218 trainable parameters,
             582,410 with BatchNorm state), K=100 clients, DSFLConfig
             defaults: 2 ERA rounds, 1 weighted-ERA round, 1 masked round
             with half the clients present.  Launch counts are zeroed just
             before the rounds and read just after: these are the kernels
             line's ``launches``.  The round never reaches K3/K4 (its
             distillation calls the plain loss, as the JAX reference's
             does), so a side check then zeroes the counts again and runs
             the distillation loss of the final state through
             ``losses.distill_xent(use_kernel=True)``; its counts are
             ``side_check_launches``.  Then one more round, timed in the
             two halves the algorithm splits it into.
 6. card vs CPU  one ERA round (K=4, full-width CNN, 1 local and 1
             distillation epoch) from the same weights and draws on the card
             (kernels) and on the CPU (plain versions), compared leaf by
             leaf.
 7. the ``{"kernels": [...]}`` line, the card's line, and the result line.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
TIMING_ITERS = 100
CARD_VS_CPU_ATOL, CARD_VS_CPU_RTOL = 2e-4, 1e-3
# the kernels the DS-FL round launches; K3/K4 sit behind
# losses.distill_xent(use_kernel=True), which the round does not call
ON_MAIN_PATH = ("era_sharpen", "weighted_era_sharpen")


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(*a):
    print(*a, flush=True)


def time_ms(fn, iters=TIMING_ITERS, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def close(out, exp, atol, rtol) -> bool:
    return bool(torch.allclose(out.float(), exp.float(), atol=atol, rtol=rtol))


def check(name, out, exp, atol, rtol=0.0):
    torch.cuda.synchronize()
    err = max_err(out, exp)
    ok = close(out, exp, atol, rtol)
    say(f"check {name}: max_abs_err={err:.3e} atol={atol} rtol={rtol} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# ------------------------------------------------------------------ phases --
def phase_device():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    say(f"device: {smi}")
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("tf32: off for matmul and cudnn (float32 runs in float32)")
    return smi


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    say(f"build: {len(logs)} sources compiled in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say(f"  ptxas[{name}] {line.strip()}")


def _probs(shape, seed, dtype=torch.float32):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(shape, generator=g, device="cuda") * 2
    return torch.softmax(x, dim=-1).to(dtype)


def _zt(N, V, seed, dtype):
    g = torch.Generator(device="cuda").manual_seed(seed)
    z = (torch.randn((N, V), generator=g, device="cuda") * 4).to(dtype)
    t = torch.softmax(torch.randn((N, V), generator=g, device="cuda"),
                      dim=-1).to(dtype)
    return z, t


def phase_kernels_and_timing():
    """Checks (phase 3) and timings (phase 4) of K1-K4.  Returns one record
    per kernel at the main path's shape, plus extra timing rows."""
    import torch.nn.functional as F
    from repro_torch.kernels import distill_loss as dl
    from repro_torch.kernels import era_sharpen as es

    recs, extra = {}, []
    T = 0.1

    # K1 / K2 ---------------------------------------------------------------
    K, N, C = 100, 1000, 10
    p = _probs((K, N, C), 1)
    w = torch.rand((K,), generator=torch.Generator(device="cuda").manual_seed(2),
                   device="cuda")
    w[0] = 0.0
    w = w / w.sum()
    e1 = check("K1 era_sharpen (100,1000,10) f32", es.era_sharpen(p, T),
               es.era_sharpen_plain(p, T), 1e-6)
    e2 = check("K2 weighted_era_sharpen (100,1000,10) f32",
               es.weighted_era_sharpen(p, w, T),
               es.weighted_era_sharpen_plain(p, w, T), 1e-6)
    e2 = max(e2, check("K2 weighted mean (sharpen=False) (100,1000,10) f32",
                       es.weighted_era_sharpen(p, w, sharpen=False),
                       es.weighted_era_sharpen_plain(p, w, sharpen=False),
                       1e-6))
    pb = _probs((3, 13, 151), 3, torch.bfloat16)
    wb = torch.tensor([0.2, 0.5, 0.3], device="cuda")
    check("K1 era_sharpen (3,13,151) bf16", es.era_sharpen(pb, T),
          es.era_sharpen_plain(pb, T), 5e-3)
    check("K2 weighted_era_sharpen (3,13,151) bf16",
          es.weighted_era_sharpen(pb, wb, T),
          es.weighted_era_sharpen_plain(pb, wb, T), 5e-3)
    pz = _probs((4, 9, 12), 4)
    garbage = pz.clone()
    garbage[0], garbage[3] = 1e30, -1e30
    wz = torch.tensor([0.0, 0.5, 0.5, 0.0], device="cuda")
    a = es.weighted_era_sharpen(pz, wz, T)
    b = es.weighted_era_sharpen(garbage, wz, T)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail("K2: a zero-weight client of +-1e30 rows changed the output bits")
    say("check K2 zero-weight clients of +-1e30 rows: output bitwise equal ok")

    in_bytes = K * N * C * 4
    out_bytes = N * C * 4
    b1, by1 = bound(in_bytes + out_bytes, K * N * C + 5 * N * C)
    b2, by2 = bound(in_bytes + K * 4 + out_bytes, 2 * K * N * C + 5 * N * C)
    recs["era_sharpen"] = dict(
        source="src/repro_torch/csrc/era_sharpen.cu",
        replaces="src/repro/kernels/era_sharpen.py:68", max_abs_err=e1,
        ms=time_ms(lambda: es.era_sharpen(p, T)),
        plain_ms=time_ms(lambda: es.era_sharpen_plain(p, T)),
        bound_ms=b1, bound_by=by1, library_ms=None, shape=[K, N, C],
        dtype="float32")
    recs["weighted_era_sharpen"] = dict(
        source="src/repro_torch/csrc/era_sharpen.cu",
        replaces="src/repro/kernels/era_sharpen.py:113", max_abs_err=e2,
        ms=time_ms(lambda: es.weighted_era_sharpen(p, w, T)),
        plain_ms=time_ms(lambda: es.weighted_era_sharpen_plain(p, w, T)),
        bound_ms=b2, bound_by=by2, library_ms=None, shape=[K, N, C],
        dtype="float32")

    # K3 / K4 ---------------------------------------------------------------
    def k34(N, V, dtype, seed, atol_f, tol_b, label):
        z, t = _zt(N, V, seed, dtype)
        loss, logz = dl.distill_loss_fwd(z, t)
        ploss, plogz = dl.distill_loss_fwd_plain(z, t)
        ef = check(f"K3 distill_loss_fwd {label}", loss, ploss, atol_f, 1e-3)
        ef = max(ef, check(f"K3 logZ {label}", logz, plogz, atol_f, 1e-3))
        tmass = t.float().sum(-1)
        gscale = torch.full((1,), 1.0 / N, device="cuda")
        dz_plain = dl.distill_loss_bwd_plain(z, t, plogz, tmass, gscale)
        eb = check(f"K4 distill_loss_bwd {label}",
                   dl.distill_loss_bwd(z, t, plogz, tmass, gscale), dz_plain,
                   *tol_b)
        if close(torch.zeros_like(dz_plain), dz_plain, *tol_b):
            fail(f"K4 {label}: the tolerance would pass a zeroed dz")
        elt = z.element_size()
        nv = N * V
        bf, byf = bound(2 * nv * elt + 2 * N * 4, 6 * nv)
        bb, byb = bound(3 * nv * elt + 2 * N * 4 + 4, 5 * nv)
        fwd = dict(max_abs_err=ef,
                   ms=time_ms(lambda: dl.distill_loss_fwd(z, t)),
                   plain_ms=time_ms(lambda: dl.distill_loss_fwd_plain(z, t)),
                   bound_ms=bf, bound_by=byf,
                   library_ms=time_ms(lambda: F.cross_entropy(
                       z, t, reduction="none")),
                   shape=[N, V], dtype=str(dtype).replace("torch.", ""))
        bwd = dict(max_abs_err=eb,
                   ms=time_ms(lambda: dl.distill_loss_bwd(z, t, plogz, tmass,
                                                          gscale)),
                   plain_ms=time_ms(lambda: dl.distill_loss_bwd_plain(
                       z, t, plogz, tmass, gscale)),
                   bound_ms=bb, bound_by=byb, library_ms=None,
                   shape=[N, V], dtype=str(dtype).replace("torch.", ""))
        return fwd, bwd

    # K4's f32 tolerance is the reference's 1e-6.  In bf16 every |dz| is at
    # most gscale = 1/N, so the tolerance scales with it: atol 1e-6/N, and
    # rtol 1e-2 for one bf16 rounding step (2^-7) of the value.
    fwd, bwd = k34(100, 10, torch.float32, 5, 1e-4, (1e-6, 0.0),
                   "(100,10) f32")
    recs["distill_loss_fwd"] = dict(
        source="src/repro_torch/csrc/distill_loss.cu",
        replaces="src/repro/kernels/distill_loss.py:74", **fwd)
    recs["distill_loss_bwd"] = dict(
        source="src/repro_torch/csrc/distill_loss.cu",
        replaces="src/repro/kernels/distill_loss.py:98", **bwd)
    for N_, V_, dt, label, af, ab in (
            (333, 50_001, torch.float32, "(333,50001) f32 ragged", 1e-4,
             (1e-6, 0.0)),
            (2048, 151_936, torch.bfloat16, "(2048,151936) bf16", 2e-2,
             (1e-6 / 2048, 1e-2))):
        f_, b_ = k34(N_, V_, dt, 6, af, ab, label)
        extra += [dict(name="distill_loss_fwd", **f_),
                  dict(name="distill_loss_bwd", **b_)]
    for name, r in list(recs.items()) + [(e["name"], e) for e in extra]:
        say(f"timing {name} {r['shape']} {r['dtype']}: ms={r['ms']:.5f} "
            f"plain_ms={r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f} "
            f"({r['bound_by']}) library_ms={r['library_ms']}")
    return recs, extra


def _paper_cnn(device):
    from repro_torch.models.smallnets import init_mnist_cnn
    return functools.partial(init_mnist_cnn, image_hw=28, widths=(32, 64),
                             fc=512, device=device)


def phase_slice():
    from torch.func import vmap

    from repro_torch.core import aggregation
    from repro_torch.core.algorithms import DSFLAlgorithm
    from repro_torch.core.client import predict_probs
    from repro_torch.core.comm import CommModel
    from repro_torch.core.engine import FedEngine, make_eval_fn
    from repro_torch.core.losses import distill_xent
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.data.pipeline import build_image_task
    from repro_torch.kernels import _build
    from repro_torch.models.smallnets import apply_mnist_cnn, param_count

    K = 100
    hp = DSFLConfig(rounds=2)
    say(f"slice: mnist_cnn 28x28 widths (32, 64) fc 512, K={K}, {hp}")
    task = build_image_task(0, K=K, n_private=20_000, n_open=10_000,
                            n_test=2_000, distribution="non_iid", hw=28,
                            device="cuda")
    algo_era = DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=True)
    algo_w = DSFLAlgorithm(apply_mnist_cnn,
                           dataclasses.replace(hp, aggregation="weighted_era"),
                           use_kernel=True)
    eng = FedEngine(algo_era, make_eval_fn(apply_mnist_cnn, task.x_test,
                                           task.y_test))
    state = eng.init(_paper_cnn("cuda"), task)
    wg, sg = state.server.params, state.server.model_state
    n_train, n_all = param_count(wg), param_count(wg, sg)
    say(f"parameters: {n_train} trainable, {n_all} with BatchNorm state")
    if (n_train, n_all) != (582_218, 582_410):
        fail(f"mnist_cnn parameter count {n_train}/{n_all}")
    cm = CommModel(K, task.n_classes, n_all, hp.open_batch)
    half = torch.zeros((1, K), device="cuda")
    half[0, ::2] = 1.0
    plan = (("era", algo_era, None), ("era", algo_era, None),
            ("weighted_era", algo_w, None), ("era masked 50/100", algo_era, half))

    torch.cuda.synchronize()
    _build.reset_launches()                       # the main path's window
    for label, algo, mask in plan:
        eng.algo = algo
        before = dict(_build.LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = eng.run(state, task, rounds=1,
                        ctx_plan=None if mask is None else {"mask": mask})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        rec = dict(eng.history[-1], aggregation=label, seconds=secs,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches={k: _build.LAUNCHES[k] - before[k]
                             for k in ON_MAIN_PATH},
                   dsfl_round_bytes=cm.dsfl_round(),
                   fedavg_round_bytes=cm.fl_round())
        say("round " + json.dumps(rec))
        for key in ("update_loss", "distill_loss", "server_distill_loss",
                    "global_entropy", "sa_entropy"):
            if not torch.isfinite(torch.tensor(rec[key])):
                fail(f"round {rec['round']}: {key} is not finite")
        need = "era_sharpen" if mask is None and label == "era" \
            else "weighted_era_sharpen"
        if rec["launches"][need] == 0:
            fail(f"round {rec['round']} ({label}) never launched {need}")

    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)              # end of the main path's window
    say(f"launches in the main path's window: {json.dumps(launches)}")
    for name in ON_MAIN_PATH:
        if launches[name] == 0:
            fail(f"kernel {name} was not launched on the main path")

    # side check, its own window: the distillation loss of the final state on
    # the kernel path (K3/K4), the server model's logits on one distillation
    # batch against the sharpened mean of the clients' predictions
    xo = task.open_x[:hp.batch_size]
    probs = vmap(lambda w, s: predict_probs(apply_mnist_cnn, w, s, xo))(
        state.clients.params, state.clients.model_state)
    teacher = aggregation.era(probs, hp.temperature)
    logits = apply_mnist_cnn(state.server.params, state.server.model_state,
                             xo, True)[0].detach().requires_grad_(True)
    torch.cuda.synchronize()
    _build.reset_launches()
    loss_k = distill_xent(logits, teacher, use_kernel=True)
    (g_k,) = torch.autograd.grad(loss_k, logits)
    torch.cuda.synchronize()
    side = dict(_build.LAUNCHES)
    loss_p = distill_xent(logits, teacher)
    (g_p,) = torch.autograd.grad(loss_p, logits)
    lk, lp = float(loss_k.detach()), float(loss_p.detach())
    say(f"side check, distill loss of the final state: kernel {lk:.6f} plain "
        f"{lp:.6f}; grad max_abs_err {max_err(g_k, g_p):.3e}; launches "
        f"{json.dumps(side)}")
    if not (abs(lk - lp) <= 1e-4 + 1e-3 * abs(lp)
            and max_err(g_k, g_p) <= 1e-5):
        fail("distillation loss on the kernel path disagrees with the plain loss")
    for name in ("distill_loss_fwd", "distill_loss_bwd"):
        if side[name] == 0:
            fail(f"kernel {name} was not launched by the side check")
    return eng, state, task, launches, side


def phase_legs(eng, state, task):
    """Where one more ERA round's time goes, split where the algorithm splits
    it: ``round_start`` (1. update, 2. prediction) and ``round_finish``
    (3-5. aggregation through K1, 6/6'. client and server distillation),
    each on the host clock around a synchronize.  Runs after the launch-count
    windows closed."""
    algo = eng.algo
    if algo.hp.aggregation != "era":
        fail(f"legs: expected the ERA algorithm, got {algo.hp.aggregation}")
    o_idx = torch.randperm(task.open_x.shape[0], generator=eng.gen,
                           device="cuda")[:algo.hp.open_batch]
    ctx = eng.make_ctx(task, o_idx=o_idx)
    legs = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        legs[name] = time.perf_counter() - t0
        return out

    inflight = timed("round_start (update, predict)",
                     lambda: algo.round_start(state, ctx, eng.gen))
    timed("round_finish (aggregate, distill clients and server)",
          lambda: algo.round_finish(state, ctx, inflight, eng.gen))
    total = sum(legs.values())
    say("legs " + json.dumps({k: {"seconds": v, "share": v / total}
                              for k, v in legs.items()}))


def phase_card_vs_cpu():
    from repro_torch import convert
    from repro_torch.core.algorithms import DSFLAlgorithm, RoundDraws
    from repro_torch.core.client import epoch_perms
    from repro_torch.core.engine import FedEngine, make_eval_fn
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.data.pipeline import FederatedImageTask, build_image_task
    from repro_torch.models.smallnets import apply_mnist_cnn

    K = 4
    hp = DSFLConfig(rounds=1, local_epochs=1, distill_epochs=1,
                    batch_size=100, open_batch=200)
    cpu_task = build_image_task(1, K=K, n_private=800, n_open=400, n_test=200,
                                distribution="non_iid", hw=28, device="cpu")
    gen = torch.Generator().manual_seed(7)
    init = _paper_cnn("cpu")
    models = [init(gen) for _ in range(K + 1)]
    n_k = cpu_task.x_clients.shape[1]
    draws = [RoundDraws(
        o_idx=torch.randperm(400, generator=gen)[:200],
        update_perms=epoch_perms(gen, K, 1, n_k, 100),
        distill_perms=epoch_perms(gen, K, 1, 200, 100),
        server_perms=epoch_perms(gen, 1, 1, 200, 100)[0])]
    results = {}
    for device in ("cuda", "cpu"):
        task = FederatedImageTask(*(t.to(device) for t in (
            cpu_task.x_clients, cpu_task.y_clients, cpu_task.open_x,
            cpu_task.x_test, cpu_task.y_test)), cpu_task.n_classes)
        mv = lambda d: {k: v.to(device) for k, v in d.items()}
        stack = lambda i: {k: torch.stack([m[i][k] for m in models[1:]]
                                          ).to(device) for k in models[0][i]}
        algo = DSFLAlgorithm(apply_mnist_cnn, hp, use_kernel=True,
                             device=device)
        eng = FedEngine(algo, make_eval_fn(apply_mnist_cnn, task.x_test,
                                           task.y_test))
        t0 = time.perf_counter()
        state = eng.run(algo.init_from(stack(0), stack(1), mv(models[0][0]),
                                       mv(models[0][1])), task, draws=draws)
        if device == "cuda":
            torch.cuda.synchronize()
        say(f"card vs cpu: {device} round in {time.perf_counter() - t0:.2f} s")
        results[device] = (convert.round_state_to_numpy(state), eng.history[-1])
    (sc, hc), (sp, h_cpu) = results["cuda"], results["cpu"]
    worst = 0.0
    for part in sc:
        for field in sc[part]:
            a = convert.flatten_tree(sc[part][field])
            b = convert.flatten_tree(sp[part][field])
            for k in b:
                d = float(abs(a[k] - b[k]).max()) if b[k].size else 0.0
                worst = max(worst, d)
                if not torch.allclose(torch.from_numpy(a[k]),
                                      torch.from_numpy(b[k]),
                                      atol=CARD_VS_CPU_ATOL,
                                      rtol=CARD_VS_CPU_RTOL):
                    fail(f"card vs cpu: {part}.{field}.{k} differs by {d:.3e}")
    for key, v in h_cpu.items():
        tol = (1.0 / 200 + 1e-6) if key == "test_acc" else \
            CARD_VS_CPU_ATOL + CARD_VS_CPU_RTOL * abs(v)
        if abs(hc[key] - v) > tol:
            fail(f"card vs cpu: metric {key} {hc[key]} vs {v}")
    say(f"card vs cpu: state leaves and metrics agree (max leaf diff "
        f"{worst:.3e}; atol {CARD_VS_CPU_ATOL}, rtol {CARD_VS_CPU_RTOL}; "
        f"test_acc within 1/200): cuda {json.dumps(hc)}")


def main():
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device; this script needs one NVIDIA GPU")
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    recs, _ = phase_kernels_and_timing()
    eng, state, task, launches, side = phase_slice()
    phase_legs(eng, state, task)
    del eng, state, task
    phase_card_vs_cpu()
    kernels = [dict(name=name, route="cuda", launches=launches[name],
                    on_main_path=name in ON_MAIN_PATH,
                    side_check_launches=side[name], check="pass", **r)
               for name, r in recs.items()]
    say(f"total {time.perf_counter() - t_start:.1f} s")
    say(f"card: {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
