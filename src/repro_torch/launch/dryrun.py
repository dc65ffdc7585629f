"""The multi-pod dry run (mirrors ``repro/launch/dryrun.py``): trace every
(architecture x input shape x mesh) on fake tensors over a fake world --
nothing is allocated, no card is needed beyond the device name -- and
record each rank's memory, FLOPs, bytes and collectives.

    python -m repro_torch.launch.dryrun --arch phi3-medium-14b --shape decode_32k
    python -m repro_torch.launch.dryrun --all --mesh both --device cpu

The world is ``torch.distributed``'s ``fake`` backend, this process its
rank 0 of 256 (the single pod's 16 x 16 "data" x "model" mesh) or 512 (the
multi-pod 2 x 16 x 16 "pod" x "data" x "model" mesh), built by
`launch.mesh.make_production_mesh`; its collectives return at once, and
`launch.collectives` logs them as on a real world.  The inputs are rank
0's slices (`launch.specs`, ``local=True``), fake tensors on ``--device``
("cuda" by default, the card's machine; "cpu" elsewhere).  The step each
record traces, as the reference lowers it:

  * train   -- ``dsfl_client_step`` (one client's hybrid CE + KD step on
    its data rows, the teacher's rows whole: `core.llm_dsfl`); on the
    multi-pod mesh ``dsfl_round_step`` with two clients on "pod";
  * prefill -- ``predict_open_probs`` (the DS-FL prediction pass);
  * decode  -- ``serve_step``: `models.api.model_decode_step` against the
    rank's part of the cache under `sharding.cache_specs`.

Each runs under the config's `launch.tp` plan (FSDP over "data", Megatron
over "model": the Mamba2 mixer on a rank's heads, the MoE FFN on its
experts, the encoder-decoder's cross-attention on its heads, the VLM's
projector on its columns) with the kernels on (``use_kernel``: K1-K5 are `kernels.library`
ops, traced through their fake implementations); an MoE decodes each token
as a routing group of its own, as `serve.engine.ServeEngine` does.  Two
passes, counted by `launch.costs`:

  * PROVE: the full config (train at ``microbatches=8``): argument bytes
    and the live peak a rank;
  * COST (the single-pod mesh only, as in the reference): the full config
    at ``microbatches=1`` (for prefill and decode the PROVE trace itself):
    FLOPs, bytes, collective bytes by kind and axis, then
    `Roofline.build` (its live peak the PROVE pass's).

Eager PyTorch runs every block, so a trace can count the full depth
(``--full-depth``); by default each pass traces 2 and 3 blocks at full
width (`reduced`) and extrapolates every count to the config's depth
(`extrapolate`: the reference's linear rule, ``_extrapolate_n``, in
integers, and for the live peak the largest of each op's extrapolated
high-water mark): a fake op costs about 0.4 ms of host time here, a train_4k block
at 8 microbatches about 30 s and a prefill_32k block about 16 s, so the
full depth of ``--all`` would take hours.  The tests hold the extrapolation
exact (FLOPs, bytes, peak, arguments, collectives, op calls) against a
deeper trace.

A record is ``ok``; ``skipped`` (`SKIPS`); ``unsupported`` for a config
the plan refuses (`launch.tp.check_family`'s message: a Mamba2 mixer the
rules would cut inside a head; no config of the repo's); or ``fail`` with
its trace.  Records land in
``experiments/dryrun_torch/`` (the reference's are ``experiments/dryrun/``)
and a finished one is not traced again.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import SHAPES, get_config, list_archs
from ..core.llm_dsfl import (LLMDsflHP, dsfl_client_step, dsfl_round_step,
                             predict_open_probs)
from ..models.api import model_decode_step
from ..models.shardctx import active_plan
from . import costs, specs, tp
from .collectives import pod_group
from .mesh import make_mesh, make_production_mesh, production_mesh_shape
from .roofline import Roofline, model_flops_estimate

SKIPS = {
    ("whisper-small", "long_500k"):
        "enc-dec with 1.5k-frame encoder and absolute positions has no "
        "500k-token decode mode; windowed variant would be a degenerate port",
}

RESULTS_DIR = "experiments/dryrun_torch"
PROVE_MICROBATCHES = 8
# the depths a record is extrapolated from: at one block the first block
# is also the last, and a prediction pass's peak there misses a buffer
# every later block holds (1.3 MB of phi3-medium-14b's 64-token prefill)
EXTRAPOLATE_FROM = (2, 3)


def reduced(cfg, n_blocks: int):
    """Same architecture at full width with n_blocks pattern-repeats."""
    kw = {"n_layers": n_blocks * len(cfg.pattern)}
    if cfg.arch_type == "audio":
        kw["enc_layers"] = n_blocks
    return cfg.replace(**kw)


_MESHES: dict = {}


def fake_world(multi_pod: bool = False, device="cuda", shape=None):
    """The production mesh (or the ("pod", "data", "model") mesh of
    ``shape``) over a fake world of its size, this process its rank 0; a
    world of another size is torn down first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dims = tuple(shape) if shape is not None else production_mesh_shape(
        multi_pod=multi_pod)
    key = (dims, shape is None, str(device))
    if key in _MESHES:
        return _MESHES[key]
    n = 1
    for d in dims:
        n *= d
    if dist.is_initialized() and dist.get_world_size() != n:
        close_world()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    _MESHES[key] = (make_production_mesh(multi_pod=multi_pod, device=device)
                    if shape is None else make_mesh(dims, device=device))
    return _MESHES[key]


def close_world() -> None:
    """Tear the fake world down (its meshes with it)."""
    import torch.distributed as dist
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def build_step(cfg, shape, mesh, *, multi_pod: bool, topk=None,
               hp_kw: dict | None = None, fsdp: bool = True, device="cuda"):
    """(step, its arguments, its name, the effective config): the step is
    a function of nothing, its arguments rank 0's fake slices."""
    n_clients = 2 if (multi_pod and shape.kind == "train") else 1
    ecfg = specs.effective_config(cfg, shape)
    if shape.kind == "decode" and ecfg.n_experts:
        # an MoE decodes each token as a routing group of its own, as
        # `serve.engine.ServeEngine` does (ROADMAP, deviation 15)
        ecfg = ecfg.replace(moe_group_size=1)
    plan = tp.plan_for(ecfg, mesh, fsdp=fsdp)   # refuses a family first
    sp = specs.input_specs(cfg, shape, n_clients=n_clients, topk=topk,
                           device=device, local=True, mesh=mesh, rank=0,
                           fsdp=fsdp)
    hp = LLMDsflHP(topk=topk, use_kernel=True, **(hp_kw or {}))
    if shape.kind == "train":
        if n_clients > 1:
            pod = pod_group(mesh)
            args = (sp["params"], sp["private"], sp["open"])
            fn = lambda: dsfl_round_step(ecfg, *args, hp, pod=pod)
            name = "dsfl_round_step"
        else:
            args = (sp["params"], sp["private"], sp["open"], sp["teacher"])
            fn = lambda: dsfl_client_step(ecfg, *args, hp)
            name = "dsfl_client_step"
    elif shape.kind == "prefill":
        args = (sp["params"], sp["open"])
        fn = lambda: predict_open_probs(ecfg, *args, use_kernel=True)
        name = "predict_open_probs"
    else:
        args = (sp["params"], sp["cache"], sp["token"], sp["pos"])

        def fn():
            with torch.no_grad():
                return model_decode_step(ecfg, *args, shape.seq_len)
        name = "serve_step"

    def step():
        with active_plan(plan):
            return fn()
    return step, args, name, ecfg, sp["mode"]


def trace(cfg, shape, mesh, *, multi_pod, topk=None, hp_kw=None, fsdp=True,
          device="cuda", sites=True):
    """One fake trace of the step under `launch.costs`: (its `Costs`, its
    name, the effective config, seconds).  ``sites=False`` leaves out
    the ops' high-water marks (a quarter of a trace's time), and with
    them the live peak's extrapolation."""
    step, args, name, ecfg, mode = build_step(
        cfg, shape, mesh, multi_pod=multi_pod, topk=topk, hp_kw=hp_kw,
        fsdp=fsdp, device=device)
    t0 = time.perf_counter()
    with mode, costs.count(*args, sites=sites) as rec:
        step()
    return rec, name, ecfg, round(time.perf_counter() - t0, 1)


def _flat(rec: costs.Costs) -> dict:
    """A record's counts as one flat dict of numbers."""
    out = {"flops": rec.flops, "bytes": rec.bytes,
           "peak_bytes": rec.peak_bytes, "arg_bytes": rec.arg_bytes}
    out.update({("ops", k): n for k, n in rec.ops.items()})
    out.update({("coll", a, k): n for a, per in rec.coll.items()
                for k, n in per.items()})
    return out


def extrapolate(ra: costs.Costs, rb: costs.Costs, na: int, nb: int,
                n_blocks: int) -> costs.Costs:
    """A full-depth record from records at ``na`` and ``nb`` blocks, every
    count linear in the blocks (the reference's ``_extrapolate_n`` rule,
    in integers, which raises where a count is not linear):
    FLOPs, bytes, the argument bytes, op calls and each axis's collective
    bytes; the live peak as the largest of the extrapolated high-water
    marks of the ops (`launch.costs`' ``site_peaks``)."""
    fa, fb = _flat(ra), _flat(rb)
    out = costs.Costs()
    sa, sb = getattr(ra, "site_peaks", {}), getattr(rb, "site_peaks", {})
    if sa and sb:
        # the peak is the largest of the ops' high-water marks, each
        # linear in the blocks on its own; which op sets it can change
        # with the depth (a step's logits at a few blocks, its gradients
        # at forty), so each is extrapolated, then the largest taken
        fa.pop("peak_bytes"), fb.pop("peak_bytes")
        out.peak_bytes = max(sa[k] + (n_blocks - na) * (
            (sb[k] - sa[k]) // (nb - na)) for k in sa.keys() & sb.keys())
    for k in fa.keys() | fb.keys():
        a, b = fa.get(k, 0), fb.get(k, 0)
        per, rest = divmod(b - a, nb - na)
        if rest:
            raise ValueError(f"{k}: {a} at {na} blocks and {b} at {nb} are "
                             f"not linear in the blocks")
        v = a + (n_blocks - na) * per
        if isinstance(k, str):
            setattr(out, k, v)
        elif k[0] == "ops":
            out.ops[k[1]] = v
        else:
            out.coll.setdefault(k[1], {})[k[2]] = v
    return out


def count_step(cfg, shape, mesh, *, multi_pod, topk=None, hp_kw=None,
               fsdp=True, device="cuda", full_depth=False, sites=True):
    """The full config's `Costs`: traced at full depth with
    ``full_depth``, else extrapolated from the depths of EXTRAPOLATE_FROM
    (`extrapolate`; the tests hold it exact against a deeper trace; with
    ``sites=False`` all but the live peak).  Returns (record, step name,
    effective config, seconds)."""
    kw = dict(multi_pod=multi_pod, topk=topk, hp_kw=hp_kw, fsdp=fsdp,
              device=device, sites=sites)
    if full_depth or cfg.n_blocks <= EXTRAPOLATE_FROM[1]:
        return trace(cfg, shape, mesh, **kw)
    na, nb = EXTRAPOLATE_FROM
    ra, name, _, sa = trace(reduced(cfg, na), shape, mesh, **kw)
    rb, _, _, sb = trace(reduced(cfg, nb), shape, mesh, **kw)
    return (extrapolate(ra, rb, na, nb, cfg.n_blocks), name,
            specs.effective_config(cfg, shape), round(sa + sb, 1))


def run_one(arch: str, shape_name: str, *, multi_pod: bool, topk=None,
            hp_kw: dict | None = None, verbose: bool = True, tag: str = "",
            cost_pass: bool = True, cfg_mod=None, fsdp: bool = True,
            device="cuda", full_depth: bool = False) -> dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    shape = SHAPES[shape_name]
    done = os.path.join(RESULTS_DIR,
                        f"{arch}_{shape_name}_{mesh_name}{tag}.json")
    if os.path.exists(done):
        with open(done) as f:
            prev = json.load(f)
        if prev.get("status") in ("ok", "skipped", "unsupported") and (
                prev.get("status") != "ok" or not cost_pass
                or "t_compute" in prev):
            if verbose:
                print(f"[SKIP-DONE] {arch} x {shape_name} x {mesh_name}",
                      flush=True)
            return prev
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if (arch, shape_name) in SKIPS:
        rec = dict(base, status="skipped", reason=SKIPS[(arch, shape_name)])
        _save(rec, tag)
        return rec
    cfg = get_config(arch)
    if cfg_mod is not None:
        cfg = cfg_mod(cfg)
    mesh = fake_world(multi_pod, device)
    try:
        tp.check_family(specs.effective_config(cfg, shape), mesh)
    except NotImplementedError as e:
        rec = dict(base, status="unsupported", reason=str(e))
        if verbose:
            print(f"[UNSUPPORTED] {arch} x {shape_name} x {mesh_name}: {e}",
                  flush=True)
        _save(rec, tag)
        return rec
    kw = dict(multi_pod=multi_pod, topk=topk, fsdp=fsdp, device=device,
              full_depth=full_depth)
    try:
        # ---- PROVE: the full config; train accumulates 8 microbatches ----
        hp_prove = dict(hp_kw or {})
        if shape.kind == "train":
            hp_prove.setdefault("microbatches", PROVE_MICROBATCHES)
        prove, step_name, ecfg, prove_s = count_step(
            cfg, shape, mesh, hp_kw=hp_prove, **kw)
        rec = dict(base, step=step_name, status="ok", trace_s=prove_s,
                   depth="full" if full_depth else "extrapolated from "
                   f"{EXTRAPOLATE_FROM[0]} and {EXTRAPOLATE_FROM[1]} blocks",
                   memory={"argument_size": prove.arg_bytes,
                           "peak_size": prove.peak_bytes,
                           "temp_size": prove.peak_bytes - prove.arg_bytes},
                   prove_ops=prove.ops)
        gb = prove.peak_bytes / 1e9
        if cost_pass:
            # ---- COST: microbatches=1 (the same trace off train) ----
            if shape.kind == "train":
                # the live peak a rank is the PROVE pass's, so this pass
                # leaves out the ops' high-water marks
                cost, _, _, cost_s = count_step(cfg, shape, mesh,
                                                hp_kw=hp_kw, sites=False,
                                                **kw)
                cost.peak_bytes = prove.peak_bytes
            else:
                cost, cost_s = prove, 0.0
            rl = Roofline.build(
                arch=arch, shape=shape_name, mesh_name=mesh_name,
                step=step_name, costs=cost,
                mesh_shape=dict(zip(mesh.mesh_dim_names,
                                    tuple(mesh.shape))),
                model_flops=model_flops_estimate(ecfg, shape))
            rec.update(rl.to_dict(), cost_s=cost_s, ops=cost.ops,
                       coll_by_axis=cost.coll)
            if verbose:
                print(f"[OK] {arch} x {shape_name} x {mesh_name} "
                      f"({step_name}) trace {prove_s}+{cost_s}s | peak "
                      f"{gb:.2f} GB/rank | t_comp {rl.t_compute*1e3:.1f}ms"
                      f" t_mem {rl.t_memory*1e3:.1f}ms"
                      f" t_coll {rl.t_collective*1e3:.1f}ms -> "
                      f"{rl.bottleneck} | useful {rl.useful_ratio:.2f}",
                      flush=True)
        elif verbose:
            print(f"[OK] {arch} x {shape_name} x {mesh_name} ({step_name}) "
                  f"trace {prove_s}s | peak {gb:.2f} GB/rank", flush=True)
    except Exception as e:  # noqa: BLE001 -- dry-run failures are findings
        rec = dict(base, status="fail", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {mesh_name}: "
                  f"{rec['error'][:300]}", flush=True)
    _save(rec, tag)
    return rec


def _save(rec: dict, tag: str = ""):
    os.makedirs(RESULTS_DIR, exist_ok=True)
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{tag}.json"
    with open(os.path.join(RESULTS_DIR, name.replace("/", "_")), "w") as f:
        json.dump(rec, f, indent=1, default=str)


def table(results) -> str:
    """The records as a markdown table, one row an (arch, shape): status,
    argument and peak GB a rank on each mesh, the cost pass's three terms
    (ms), bottleneck and useful ratio; the unsupported records counted
    under it by family."""
    rows = ["| arch | shape | status | args GB | peak GB | 2x16x16 args, "
            "peak GB | t_comp ms | t_mem ms | t_coll ms | bottleneck | "
            "useful |", "|" + " --- |" * 11]
    by = {}
    for r in results:
        by.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    gb = lambda r, k: (f"{r['memory'][k] / 1e9:.2f}" if r and "memory" in r
                       else "")
    unsupported = {}
    for (arch, shape), meshes in by.items():
        one, two = meshes.get("16x16"), meshes.get("2x16x16")
        r = one or two
        if r["status"] == "unsupported":
            unsupported[arch] = unsupported.get(arch, 0) + len(meshes)
            continue
        ms = lambda k: f"{r[k] * 1e3:.1f}" if k in r else ""
        rows.append(" | ".join([
            f"| {arch}", shape, r["status"], gb(one, "argument_size"),
            gb(one, "peak_size"),
            f"{gb(two, 'argument_size')}, {gb(two, 'peak_size')}"
            if two and "memory" in two else "", ms("t_compute"),
            ms("t_memory"), ms("t_collective"), r.get("bottleneck", ""),
            f"{r['useful_ratio']:.2f}" if "useful_ratio" in r else ""])
            + " |")
    if unsupported:
        rows.append("\nunsupported (records): " + ", ".join(
            f"{a} {n}" for a, n in sorted(unsupported.items())))
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--topk", type=int, default=None,
                    help="sparsified logit exchange (beyond-paper opt)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-cost", action="store_true",
                    help="prove-only (skip the cost pass)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (no memory is taken)")
    ap.add_argument("--full-depth", action="store_true",
                    help="trace every block (default: 2 and 3 blocks, "
                         "extrapolated)")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results = []
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                # the cost pass only on the single-pod mesh, as the reference
                results.append(run_one(arch, shape, multi_pod=mp,
                                       topk=args.topk, tag=args.tag,
                                       cost_pass=(not args.no_cost) and not mp,
                                       device=args.device,
                                       full_depth=args.full_depth))
    print("\n" + table(results))
    n = {s: sum(r["status"] == s for r in results)
         for s in ("ok", "skipped", "unsupported")}
    failed = len(results) - sum(n.values())
    print(f"\n{n['ok']} ok / {n['skipped']} skipped / {n['unsupported']} "
          f"unsupported / {failed} failed of {len(results)}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
