"""Every LLM round kind over the ranks of a mesh, and the same rounds in
one process, for the checks that hold the one against the other (the CPU
tests over gloo, chip_smoke.py's phases "pod" and "tp" on the card,
tools/pod_cards.py across cards).

`run_cases(spec, mesh)` runs the cases of ``spec`` (`CASES` by name)
through `FedEngine` on this rank's part of the client stack (``mesh`` a
client mesh, or the ("pod", "data", "model") mesh of ``spec.mesh_shape``,
whose "data" and "model" axes split each client's leaves: `launch.tp`) or,
with ``mesh=None``, on the whole client stack in this process.  Each case
starts from the state ``spec.init_path`` holds (loaded with
``shardings=`` over a mesh) or from the keyed init (a round leaves its
input state as it was), and with ``spec.chain`` from the previous case's
state instead.  It returns, per
case, the history, this rank's parameters (CPU copies, or with
``spec.fingerprint`` each lane's `fingerprint` leaf by leaf), the
collectives log, the kernels' launches, the seconds and the peak memory.
Each case also records, per leaf, how far its rounds moved the leaf
("moved": the largest |after - before| where it lies), which says what a
comparison at a given tolerance can see.  ``spec.keep_values`` keeps a
case's leaves where they lie (clones, under "values").  Given ``compare``
({case: {leaf: the one-process (K, ...) stack}}, e.g. such values, which
the spawn shares with the ranks: CUDA memory by handle), a rank holds its
slices of those cases against the leaves' `local_slice` where they lie and
returns, per leaf, the largest difference and the largest reference
magnitude instead of the parameters.  ``spec.fault`` plants a fault the
comparison must catch: rank `FAULT_RANK` starts each case with its slice
of the config's `fault_leaf` ``1 + FAULT`` times what it should be.
`rank_main_many` is the program of one spawned rank (`launch.dist.spawn`)
running several specs, each over its own mesh; `rank_main` runs one.

`MoEFFNSpec`, `moe_ffn_pass` and `moe_ffn_rank` hold one MoE FFN under
expert parallelism against the same FFN in one process: a seeded layer
and tokens, the forward and the backward of ``sum(out * g) + aux``, each
rank on its experts' slices (``fault``: rank `FAULT_RANK`'s ``w_down``
slice 1% off), compared where the slices lie, and the dropped (token,
choice) pairs counted on both sides.  Each rank makes the one-process
reference itself, so nothing of it is shared through the spawn.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..configs import get_config
from ..core.engine import FedEngine
from ..core.llm_algorithms import (LLMDSFLAlgorithm, LLMFedAvgAlgorithm,
                                   LLMFedAvgHP)
from ..core.llm_dsfl import LLMDsflHP
from ..data.pipeline import build_lm_task
from ..kernels import _build
from ..models import moe
from ..models.api import model_init
from ..models.shardctx import active_plan
from . import collectives
from .mesh import make_client_mesh, make_mesh
from .train import extra_inputs

# name -> (algorithm, rounds, FedEngine.run keywords, LLMDsflHP fields,
#          participation plan: None, "stale" (everyone in, every other
#          client one round stale) or "half" (every other client absent),
#          sparse: the half plan at budget K/2)
CASES = {
    "load": ("dsfl", 0, {}, {}, None, False),
    "dsfl": ("dsfl", 1, {}, {}, None, False),
    "era": ("dsfl", 2, {}, {}, None, False),
    "era_chunk": ("dsfl", 2, {"chunk_rounds": 2}, {}, None, False),
    "era_overlap": ("dsfl", 2, {"chunk_rounds": 2, "overlap": True}, {},
                    None, False),
    "weighted": ("dsfl", 1, {}, {}, "stale", False),
    "masked": ("dsfl", 1, {}, {}, "half", False),
    "sparse": ("dsfl", 1, {}, {}, "half", True),
    "topk": ("dsfl", 1, {}, {"topk": 8}, None, False),
    "fedavg": ("fedavg", 1, {}, {}, None, False),
    "fedavg_sparse": ("fedavg", 1, {}, {}, "half", True),
    "ckpt": ("dsfl", 1, {}, {}, None, False),
}
# the fault a comparison must catch: one rank's slice of a leaf
# (`fault_leaf`: this one where the first sub-layer has an FFN), 1% off
# before the round
FAULT_LEAF = "blocks/s0_ffn/w_down"
FAULT = 1e-2
FAULT_RANK = 1


def fault_leaf(cfg) -> str:
    """The leaf a fault is planted in: the first FFN's ``w_down`` (the
    MoE family's first expert stack, the encoder-decoder's decoder MLP),
    the VLM's projector (its columns over "model"), or, without an FFN
    (Mamba2), the first mixer's ``w_out``."""
    if cfg.arch_type == "audio":
        return "dec/mlp/w_down"
    if cfg.arch_type == "vlm":
        return "patch_proj/w"
    if cfg.arch_type == "moe":
        i = next(i for i, (_, f) in enumerate(cfg.pattern) if f == "moe")
        return f"blocks/s{i}_ffn/w_down"
    return FAULT_LEAF if cfg.pattern[0][1] != "none" \
        else "blocks/s0_mix/w_out"


@dataclass(frozen=True)
class DrillSpec:
    arch: str = "qwen1.5-4b"
    smoke: bool = True
    n_layers: Optional[int] = None      # a depth cut (None: the config's;
                                        # an encoder's too)
    clients: int = 2
    batch: int = 2
    seq: int = 32
    lr: float = 5e-3
    device: str = "cpu"
    use_kernel: bool = False
    topk: Optional[int] = None          # the DS-FL cases' exchange, "topk"'s 8
    scale_embedding: bool = False       # the embedding times d_model^-1/2
    cases: tuple = tuple(CASES)
    init_path: Optional[str] = None     # a one-process save_state file
    out_dir: Optional[str] = None       # where "ckpt" saves (<tag>.msgpack)
    tag: str = "one"
    chain: bool = False
    fingerprint: bool = False
    preset: Optional[str] = None        # a launch.platform preset (ranks)
    mesh_shape: Optional[tuple] = None  # ("pod", "data", "model") sizes
    overrides: tuple = ()               # (field, value) pairs of the config
    keep_values: tuple = ()             # cases whose leaves stay where they
                                        # lie as "values" (clones)
    fault: bool = False                 # FAULT_RANK's FAULT_LEAF 1% off

    def config(self):
        """The config, ``n_layers`` cutting the decoder and, of an
        encoder-decoder, the encoder to that depth (as `dryrun.reduced`
        does)."""
        cfg = get_config(self.arch)
        cfg = cfg.smoke() if self.smoke else cfg
        if self.n_layers is not None:
            cfg = cfg.replace(n_layers=self.n_layers, **(
                {"enc_layers": self.n_layers} if cfg.enc_layers else {}))
        return cfg.replace(**dict(self.overrides)) if self.overrides else cfg

    def mesh(self, device):
        """This rank's mesh: ``mesh_shape``'s, else the client mesh."""
        if self.mesh_shape is not None:
            return make_mesh(self.mesh_shape, device=device)
        return make_client_mesh(self.clients, device=device)


def fingerprint(t: torch.Tensor, chunk: int = 1 << 26) -> tuple[int, float]:
    """(the int64 sum of a tensor's bit patterns, its float64 sum), over
    slices of ``chunk`` values at a time: equal fingerprints on equal
    tensors, computed where the tensor lies."""
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    flat = t.contiguous().reshape(-1)
    ints, floats = 0, 0.0
    for i in range(0, flat.numel(), chunk):
        part = flat[i:i + chunk]
        ints += int(part.view(bits).to(torch.int64).sum())
        floats += float(part.to(torch.float64).sum())
    return ints, floats


def lane_fingerprints(params: dict) -> dict:
    """{leaf: [the `fingerprint` of each lane of the client stack]}."""
    return {k: [fingerprint(v[i]) for i in range(v.shape[0])]
            for k, v in params.items()}


def _plan(kind, K: int, rounds: int, device) -> Optional[dict]:
    if kind is None:
        return None
    odd = torch.arange(K, device=device) % 2
    if kind == "stale":
        mask, stale = torch.ones(K, device=device), odd.to(torch.int32)
    else:
        mask, stale = (1 - odd).to(torch.float32), torch.zeros(
            K, dtype=torch.int32, device=device)
    return {"mask": mask.expand(rounds, K), "stale": stale.expand(rounds, K)}


def _init_fn(cfg, spec: DrillSpec, device):
    def init(gen):
        params = model_init(cfg, gen, device)
        if spec.scale_embedding:
            params["embed/tok"].mul_(cfg.d_model ** -0.5)
        return params
    return init


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _start(spec: DrillSpec, cfg, task, mesh, device):
    """The state the cases start from: the keyed init of this rank's
    clients, or their part of ``spec.init_path`` (written by DS-FL)."""
    eng = FedEngine(LLMDSFLAlgorithm(cfg, LLMDsflHP(), device=device,
                                     mesh=mesh), mesh=mesh)
    state = eng.init(_init_fn(cfg, spec, device), task)
    if spec.init_path is None:
        return state
    sh = (None if mesh is None
          else eng.algo.shardings(mesh, state, eng.make_ctx(task))[0])
    return eng.load_state(spec.init_path, state, shardings=sh)


def compare_slices(params: dict, ref: dict, specs: dict, mesh, rank: int
                   ) -> dict:
    """Per leaf, the largest |this rank's slice - the reference's| and the
    largest |reference| there."""
    from .sharding import local_slice
    out = {"max_abs": {}, "max_ref": {}}
    for k, v in params.items():
        want = local_slice(ref[k], specs[k], mesh, rank).to(v.device)
        diff = (v.to(torch.float32) - want.to(torch.float32)).abs()
        out["max_abs"][k] = float(diff.max())
        out["max_ref"][k] = float(want.abs().max())
    return out


def _moved(before: dict, after: dict) -> dict:
    """Per leaf, the largest |after - before| (lane by lane, in the leaf's
    dtype: the difference of two close values is exact)."""
    return {k: max(float((v[i] - before[k][i]).abs().max())
                   for i in range(v.shape[0]))
            for k, v in after.items()}


def _with_fault(state, cfg):
    """``state`` with ``cfg``'s `fault_leaf` times 1 + FAULT on rank
    `FAULT_RANK` (every rank of one process)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_rank() != FAULT_RANK:
        return state
    params = dict(state.clients.params)
    leaf = fault_leaf(cfg)
    params[leaf] = params[leaf] * (1 + FAULT)
    return replace(state, clients=replace(state.clients, params=params))


def run_cases(spec: DrillSpec, mesh=None, device=None,
              compare: Optional[dict] = None) -> dict:
    """The cases of ``spec`` over ``mesh`` (None: one process)."""
    cfg = spec.config()
    device = torch.device(spec.device) if device is None else device
    task = build_lm_task(0, spec.clients, spec.batch, spec.seq, cfg.vocab,
                         extras_fn=lambda b, g: extra_inputs(cfg, b, g),
                         device=device)
    K, out = spec.clients, {}
    state = _start(spec, cfg, task, mesh, device)
    if spec.fault:
        state = _with_fault(state, cfg)
    state0 = None if spec.chain else state
    for name in spec.cases:
        kind, rounds, run_kw, hp_kw, plan, sparse = CASES[name]
        if kind == "dsfl":
            algo = LLMDSFLAlgorithm(cfg, LLMDsflHP(
                lr=spec.lr, open_batch=spec.batch,
                use_kernel=spec.use_kernel,
                **{"topk": spec.topk, **hp_kw}), device=device, mesh=mesh)
        else:
            algo = LLMFedAvgAlgorithm(cfg, LLMFedAvgHP(lr=spec.lr),
                                      device=device, mesh=mesh)
        eng = FedEngine(algo, mesh=mesh)
        if not spec.chain:
            state = state0
        before = state.clients.params
        _build.reset_launches()
        collectives.reset_log()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        t0 = time.perf_counter()
        if rounds:
            state = eng.run(state, task, rounds=rounds,
                            ctx_plan=_plan(plan, K, rounds, device),
                            active_budget=K // 2 if sparse else None,
                            **run_kw)
        _sync(device)
        rec = {"seconds": time.perf_counter() - t0,
               "history": list(eng.history),
               "log": collectives.log(),
               "launches": dict(_build.LAUNCHES),
               "peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None)}
        params = state.clients.params
        rec["moved"] = _moved(before, params)
        if name in spec.keep_values:
            rec["values"] = {k: v.detach().clone() for k, v in params.items()}
        if compare is not None and name in compare:
            import torch.distributed as dist
            specs = algo.shardings(mesh, state, eng.make_ctx(task))[0]
            rec.update(compare_slices(params, compare[name],
                                      specs.clients.params, mesh,
                                      dist.get_rank()))
        elif spec.fingerprint:
            rec["params"] = lane_fingerprints(params)
        elif name not in spec.keep_values:
            rec["params"] = {k: v.detach().to("cpu", copy=True)
                             for k, v in params.items()}
        if name == "ckpt" and spec.out_dir is not None:
            eng.save_state(os.path.join(spec.out_dir, f"{spec.tag}.msgpack"),
                           state)
        out[name] = rec
    return out


def rank_main_many(rank: int, world: int, specs: tuple,
                   compares: tuple) -> list:
    """One spawned rank: its device (the card ``rank % device_count``, or
    the CPU when the first spec says so), then each spec over its own mesh,
    under its preset, its cases held to ``compares``' entry (None:
    returned)."""
    from . import platform
    from .dist import rank_device
    device = rank_device(specs[0].device, rank, world)
    out = []
    for spec, compare in zip(specs, compares):
        prev = platform.snapshot()
        if spec.preset is not None:
            platform.apply(spec.preset)
        try:
            out.append(run_cases(replace(spec, tag=f"pod{world}"),
                                 spec.mesh(device), device, compare))
        finally:
            platform.restore(prev)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    # let the shared leaves go before this process ends, so the parent can
    # free them (`torch.cuda.ipc_collect`): the spawn holds ``compares``
    # until the interpreter exits, which releases nothing
    for compare in compares:
        if compare is not None:
            compare.clear()
    return out


def rank_main(rank: int, world: int, spec: DrillSpec,
              compare: Optional[dict] = None) -> dict:
    """One spawned rank running one spec (`rank_main_many`)."""
    return rank_main_many(rank, world, (spec,), (compare,))[0]


# ------------------------------------------------- one MoE FFN, held ----
@dataclass(frozen=True)
class MoEFFNSpec:
    """One MoE FFN of ``arch`` (its smoke config with ``smoke``) on
    ``tokens`` tokens in routing groups of ``group``, over the mesh
    ``mesh_shape`` (None: one process)."""
    arch: str = "llama4-scout-17b-a16e"
    smoke: bool = False
    tokens: int = 1024
    group: int = 256
    dtype: str = "float32"
    seed: int = 0
    device: str = "cpu"
    mesh_shape: Optional[tuple] = (1, 1, 2)
    fault: bool = False

    def config(self):
        """One pattern-repeat of the config, whose first MoE FFN runs."""
        cfg = get_config(self.arch)
        cfg = cfg.smoke() if self.smoke else cfg
        return cfg.replace(n_layers=len(cfg.pattern), dtype=self.dtype,
                           moe_group_size=self.group)

    @property
    def leaf(self) -> str:
        """The FFN's stacked-leaf prefix (the specs' names)."""
        i = next(i for i, (_, f) in enumerate(self.config().pattern)
                 if f == "moe")
        return f"blocks/s{i}_ffn/"


def moe_ffn_inputs(spec: MoEFFNSpec, device) -> tuple:
    """(the seeded layer's leaves, tokens (1, T, d), the output's
    upstream gradient), made on ``device``."""
    cfg = spec.config()
    gen = torch.Generator(device=device).manual_seed(spec.seed)
    params = moe.init_moe(gen, cfg, device)
    x = torch.randn((1, spec.tokens, cfg.d_model), generator=gen,
                    device=device).to(cfg.cdtype)
    g = torch.randn((1, spec.tokens, cfg.d_model), generator=gen,
                    device=device).to(cfg.cdtype)
    return params, x, g


def moe_ffn_pass(spec: MoEFFNSpec, params: dict, x, g, plan=None) -> dict:
    """The FFN's output, aux loss and the gradients of ``sum(out * g) +
    aux`` for its leaves (under ``plan``: the rank's slices) and ``x``,
    the dropped (token, choice) pairs, and the seconds of the pass."""
    cfg = spec.config()
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    xx = x.detach().requires_grad_()
    _sync(x.device)
    t0 = time.perf_counter()
    with active_plan(plan):
        out, aux = moe.moe_ffn(leaves, cfg, xx)
        loss = (out.float() * g.float()).sum() + aux
        grads = torch.autograd.grad(loss, [*leaves.values(), xx])
    _sync(x.device)
    seconds = time.perf_counter() - t0
    keep = moe.route(params, cfg, x.reshape(-1, spec.group, cfg.d_model))[3]
    return dict(out=out.detach(), aux=aux.detach(), seconds=seconds,
                grads=dict(zip([*leaves, "x"], grads)),
                dropped=int((~keep).sum()))


def moe_ffn_rank(rank: int, world: int, spec: MoEFFNSpec) -> dict:
    """One spawned rank: the seeded FFN whole in one process on this
    rank's device (the reference: the same draws on every device), then
    its experts' slices under the plan of ``spec.mesh_shape``; per tensor
    the largest difference from the one-process one where the rank's part
    lies, beside that part's largest magnitude."""
    import torch.distributed as dist

    from . import tp
    from .dist import rank_device
    from .sharding import local_slice
    device = rank_device(spec.device, rank, world)
    cfg = spec.config()
    mesh = make_mesh(spec.mesh_shape, device=device)
    plan = tp.plan_for(cfg, mesh)
    me = dist.get_rank()
    params, x, g = moe_ffn_inputs(spec, device)
    ref = moe_ffn_pass(spec, params, x, g)
    specs = {k: plan.specs[spec.leaf + k][1:] for k in params}
    cut = lambda t, k: local_slice(t, specs[k], mesh, me).clone()
    want = {"out": ref["out"], "aux": ref["aux"], "x": ref["grads"]["x"],
            **{k: cut(ref["grads"][k], k) for k in params}}
    mine = {k: cut(v, k) for k, v in params.items()}
    del params, ref["grads"]
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if spec.fault and me == FAULT_RANK:
        mine["w_down"].mul_(1 + FAULT)
    collectives.reset_log()
    got = moe_ffn_pass(spec, mine, x, g, plan)
    have = {"out": got["out"], "aux": got["aux"], **got["grads"]}
    out = dict(max_abs={k: float((have[k].float() - w.float()).abs().max())
                        for k, w in want.items()},
               max_ref={k: float(w.float().abs().max())
                        for k, w in want.items()},
               dropped=got["dropped"], seconds=got["seconds"],
               one_process_dropped=ref["dropped"],
               one_process_seconds=ref["seconds"], log=collectives.log(),
               ep=plan.ep, experts=mine["w_up"].shape[0])
    del mine, got, want, have
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out
