"""Every LLM round kind over the "pod" ranks, and the same rounds in one
process, for the checks that hold the one against the other (the CPU
tests over gloo, chip_smoke.py's phase "pod" on the card).

`run_cases(spec, mesh)` runs the cases of ``spec`` (`CASES` by name)
through `FedEngine` on this rank's lanes (``mesh`` a client mesh) or, with
``mesh=None``, on the whole client stack in this process.  Each case
starts from the state ``spec.init_path`` holds (loaded with
``shardings=`` over a mesh) or from the keyed init (a round leaves its
input state as it was), and with ``spec.chain`` from the previous case's
state instead.  It returns, per
case, the history, this rank's parameters (CPU copies, or with
``spec.fingerprint`` each lane's `fingerprint` leaf by leaf), the
collectives log, the kernels' launches, the seconds and the peak memory.  `rank_main` is the
program of one spawned rank (`launch.dist.spawn`).
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
from ..models.api import model_init
from . import collectives
from .mesh import make_client_mesh

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


@dataclass(frozen=True)
class DrillSpec:
    arch: str = "qwen1.5-4b"
    smoke: bool = True
    n_layers: Optional[int] = None      # a depth cut (None: the config's)
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

    def config(self):
        cfg = get_config(self.arch)
        cfg = cfg.smoke() if self.smoke else cfg
        return cfg if self.n_layers is None else cfg.replace(
            n_layers=self.n_layers)


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


def run_cases(spec: DrillSpec, mesh=None, device=None) -> dict:
    """The cases of ``spec`` over ``mesh`` (None: one process)."""
    cfg = spec.config()
    device = torch.device(spec.device) if device is None else device
    task = build_lm_task(0, spec.clients, spec.batch, spec.seq, cfg.vocab,
                         device=device)
    K, out = spec.clients, {}
    state = _start(spec, cfg, task, mesh, device)
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
        rec["params"] = (lane_fingerprints(params) if spec.fingerprint else
                         {k: v.detach().to("cpu", copy=True)
                          for k, v in params.items()})
        if name == "ckpt" and spec.out_dir is not None:
            eng.save_state(os.path.join(spec.out_dir, f"{spec.tag}.msgpack"),
                           state)
        out[name] = rec
    return out


def rank_main(rank: int, world: int, spec: DrillSpec) -> dict:
    """One spawned rank: its device (the card ``rank % device_count``, or
    the CPU when ``spec.device`` says so), the client mesh, the cases."""
    from . import platform
    from .dist import rank_device
    device = rank_device(spec.device, rank, world)
    if spec.preset is not None:
        platform.apply(spec.preset)
    mesh = make_client_mesh(spec.clients, device=device)
    return run_cases(replace(spec, tag=f"pod{world}"), mesh, device)
