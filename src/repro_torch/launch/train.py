"""LLM training entry point (mirrors ``repro/launch/train.py``).

Three modes, the federated ones through `FedEngine` and the LLM algorithms
(`core.llm_algorithms`):
  * ``--mode dsfl``   - the paper's protocol at LLM scale: K clients, logit
    exchange on a shared open batch, ERA aggregation, hybrid CE+KD local
    steps; the prediction on K5, the teacher on K1/K2, the KD term on K3/K4.
  * ``--mode fedavg`` - FedAvg at LLM scale: local SGD + parameter mean (the
    exchange the paper's byte claim is measured against).
  * ``--mode local``  - plain LM training of one model (the "1. Update" step).

``--participation``/``--straggler`` run the federated modes through the
simulator (`sim.SimRunner`): a lognormal mobile fleet, uniform sampling and
a virtual clock charged from the measured wire bytes; a round with fewer
participants than clients computes only the participants.
``--chunk-rounds k`` runs k rounds a chunk with one host sync a chunk
(the same bits as one round at a time); ``--overlap`` asks for the
pipelined schedule, which makes the same calls.  ``--ckpt`` writes the
state, the round counter and the history in the reference's msgpack layout.

Runs on the card unless ``--device cpu`` is given (the kernels' plain
versions), e.g.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --mode dsfl --clients 2 --steps 2 [--topk 8]
  PYTHONPATH=src python -m repro_torch.launch.train    # qwen1.5-4b, card

Every arch trains; at full width one card holds K = 2 stacks of
qwen1.5-4b (the reference's default), mamba2-2.7b, phi-3-vision-4.2b or
whisper-small.  A VLM's batches carry random patch features and an audio
model's random frame embeddings (`extra_inputs`, the stub frontends),
drawn from the task's generator and shared by every client and the open
set.
``--trace out.jsonl`` / ``--metrics out.json`` record the run
(`obs.cli`); ``--platform-preset`` sets torch's numeric switches first
(`launch.platform`: TF32 off, deterministic algorithms).

``--world N`` runs the federated modes over N ranks on the mesh
`launch.mesh.make_client_mesh` shapes: the clients on "pod" when N is a
multiple of the client count, every other rank on "model" (world 2 at K =
2 is (2, 1, 1), world 4 at K = 2 (2, 1, 2), world 2 at K = 1 (1, 1, 2)).
Where "model" has more than one rank, every family splits each client's
leaves over it (tensor parallelism, `launch.tp`).  `core.llm_dsfl` says
what crosses between ranks.  The script spawns the ranks itself (`launch.dist`), or under
``torchrun`` it takes the world from ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK``.  Ranks use ``cuda:LOCAL_RANK % device_count`` (``--device
cpu``: the CPU) and the backend ``--backend`` names (``nccl`` by default;
``gloo`` for two ranks on one card or on the CPU); rank 0 prints, e.g.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --world 2 --backend gloo
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --world 4 --backend gloo      # K = 2 on (2, 1, 2)
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --smoke --device cpu --backend gloo
"""
from __future__ import annotations

import argparse
import contextlib
import io
import math
import time
from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..checkpoint import save_pytree
from ..configs import get_config, list_archs
from ..core import wire
from ..core.comm import fmt_bytes
from ..core.engine import FedEngine
from ..core.llm_algorithms import (LLMDSFLAlgorithm, LLMFedAvgAlgorithm,
                                   LLMFedAvgHP)
from ..core.llm_dsfl import LLMDsflHP, sgd_train_step
from ..data.pipeline import build_lm_task, lm_open_batch
from ..device import generator, resolve_device
from ..models.api import model_init
from ..models.base import param_count
from ..obs import cli as obs_cli
from . import dist, platform
from .mesh import make_client_mesh
from .sharding import model_shapes


def extra_inputs(cfg, batch: int, gen: torch.Generator) -> dict:
    """The stub frontends' inputs of ``batch`` sequences, unit normal in
    f32 drawn from ``gen`` and cast to the model's dtype: a VLM's
    ``patches`` (batch, n_patches, d_model), an audio model's ``frames``
    (batch, n_audio_frames, d_model); none for the other families."""
    width = {"vlm": ("patches", cfg.n_patches),
             "audio": ("frames", cfg.n_audio_frames)}.get(cfg.arch_type)
    if width is None:
        return {}
    name, n = width
    return {name: torch.randn((batch, n, cfg.d_model), generator=gen,
                              device=gen.device,
                              dtype=torch.float32).to(cfg.cdtype)}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b", choices=list_archs())
    ap.add_argument("--mode", default="dsfl",
                    choices=["dsfl", "fedavg", "local"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--clients", type=int, default=2)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--gamma", type=float, default=1.0)
    ap.add_argument("--aggregation", default="era", choices=["era", "sa"])
    ap.add_argument("--topk", type=int, default=None)
    ap.add_argument("--participation", type=float, default=1.0,
                    help="fraction of clients sampled per round (<1 runs the "
                         "round through the simulator)")
    ap.add_argument("--straggler", type=float, default=None,
                    help="virtual-seconds round deadline; late clients are "
                         "dropped (or admitted late with --straggler-policy)")
    ap.add_argument("--straggler-policy", default="drop",
                    choices=["drop", "admit"])
    ap.add_argument("--chunk-rounds", type=int, default=1,
                    help="rounds a chunk, one host sync a chunk (the same "
                         "bits as one round at a time)")
    ap.add_argument("--overlap", action="store_true",
                    help="the pipelined schedule (the same calls; needs "
                         "--chunk-rounds >= 2)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where to run (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to run the clients over (spawned here; "
                         "under torchrun its WORLD_SIZE)")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="the ranks' torch.distributed backend")
    obs_cli.add_args(ap)
    platform.add_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if dist.under_torchrun():
        rank, world, device = dist.init_from_env(args.backend, args.device)
        _rank_run(rank, world, args, device)
        dist.close()
    elif args.world is not None:
        dist.spawn(_spawned_rank, args.world, args, backend=args.backend)
    else:
        # the preset first: the session's provenance stamps it
        platform.from_args(args)
        with obs_cli.session(args):
            run(args)


def _spawned_rank(rank: int, world: int, args) -> None:
    _rank_run(rank, world, args, dist.rank_device(args.device, rank, world))


def _rank_run(rank: int, world: int, args, device) -> None:
    """One rank of a ``--world`` run: the preset, the client mesh, the
    run; rank 0 prints and records, the others stay silent."""
    platform.from_args(args)
    mesh = make_client_mesh(args.clients, device=device)
    args = argparse.Namespace(**{**vars(args), "device": str(device)})
    if rank == 0:
        with obs_cli.session(args):
            run(args, mesh)
        return
    quiet = argparse.Namespace(**{**vars(args), "trace": None,
                                  "metrics": None})
    with contextlib.redirect_stdout(io.StringIO()):
        run(quiet, mesh)


@dataclass
class Federation:
    """A federated run set up by `setup`: the engine (and the simulator's
    runner under ``--participation``/``--straggler``), its state and task,
    and the measured bytes a round."""
    args: argparse.Namespace
    cfg: Any
    task: Any
    engine: FedEngine
    state: Any
    runner: Optional[Any]
    params_per_client: int
    exchange_bytes: int
    fedavg_bytes: int


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _config(args):
    """The model config (``--smoke`` cuts it) and the device; prints the
    arch line."""
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    print(f"arch={cfg.name} ({cfg.arch_type}) layers={cfg.n_layers} "
          f"d={cfg.d_model} vocab={cfg.vocab} device={device}")
    return cfg, device


def setup(args, mesh=None) -> Federation:
    """Config, task, algorithm, engine and the clients' models; prints the
    arch, params/client and exchange/round lines.  Over ``mesh`` the
    engine holds this rank's clients."""
    cfg, device = _config(args)
    K = args.clients
    task = build_lm_task(args.seed, K, args.batch, args.seq, cfg.vocab,
                         extras_fn=lambda b, g: extra_inputs(cfg, b, g),
                         device=device)
    if args.mode == "dsfl":
        hp = LLMDsflHP(lr=args.lr, gamma=args.gamma,
                       aggregation=args.aggregation, topk=args.topk,
                       rounds=args.steps, seed=args.seed,
                       open_batch=args.batch, use_kernel=True)
        algo = LLMDSFLAlgorithm(cfg, hp, device=device)
        # the wire leg: top-k (value, index) pairs when sparsified, else
        # half-precision distributions (2 bytes each)
        codec = (wire.TopKCodec(k=args.topk, n_classes=cfg.vocab)
                 if args.topk else wire.FP16Codec())
    else:
        algo = LLMFedAvgAlgorithm(cfg, LLMFedAvgHP(
            lr=args.lr, rounds=args.steps, seed=args.seed), device=device)
        codec = wire.DenseF32Codec()
    eng = FedEngine(algo, codec=codec, mesh=mesh)
    state = eng.init(lambda g: model_init(cfg, g, device), task)
    # a client's whole leaves, whatever slices of them this rank holds
    whole = model_shapes(cfg)
    n_params = sum(math.prod(v.shape) for v in whole.values())
    print(f"params/client: {n_params:,}")
    # measured bytes a round on one real encoded payload, the LLM-scale
    # counterpart of the paper's Table 1/2 upload accounting
    ex_bytes = eng.measured_round_bytes(state, task)
    fedavg_bytes = (K + 1) * sum(
        math.prod(v.shape) * state.clients.params[k].element_size()
        for k, v in whole.items())
    print(f"exchange/round: {fmt_bytes(ex_bytes)} (FedAvg parameter "
          f"exchange would be {fmt_bytes(fedavg_bytes)})")
    runner = None
    if args.participation < 1.0 or args.straggler is not None:
        if args.overlap:
            print("note: --overlap applies to the direct engine path; the "
                  "simulated rounds keep the sequential schedule")
        from ..sim import ClientPopulation, SimRunner, SyncScheduler
        pop = ClientPopulation.lognormal(args.seed, K)
        runner = SimRunner(eng, SyncScheduler(
            pop, fraction=args.participation, deadline=args.straggler,
            straggler=args.straggler_policy), seed=args.seed)
    return Federation(args, cfg, task, eng, state, runner, n_params,
                      ex_bytes, fedavg_bytes)


def run_rounds(fed: Federation, rounds: int,
               active_budget="auto") -> list[dict]:
    """``rounds`` rounds in chunks of ``--chunk-rounds``; prints a line a
    round and returns one record a round with its loss and seconds (the
    chunk's host time over a synchronized device, split evenly).
    ``active_budget`` goes to the simulator's runner: ``"auto"`` computes
    only each round's participants, None the dense masked round."""
    args, eng = fed.args, fed.engine
    K = args.clients
    out, done = [], 0
    while done < rounds:
        k = max(1, min(args.chunk_rounds, rounds - done))
        t0 = time.perf_counter()
        if fed.runner is not None:
            fed.state = fed.runner.run(fed.state, fed.task, rounds=k,
                                       chunk_rounds=k,
                                       active_budget=active_budget)
            _sync(eng.device)
            dt = (time.perf_counter() - t0) / k
            for rec in fed.runner.history.records[-k:]:
                print(f"round {rec['round'] - 1:3d}  loss {rec['loss']:.4f}"
                      f"  vt {rec['t_cum']:8.1f}s  {rec['participants']}/{K}"
                      f" clients  {dt:.2f}s/round", flush=True)
                out.append(dict(rec, seconds=dt))
        else:
            fed.state = eng.run(fed.state, fed.task, rounds=k,
                                chunk_rounds=k, overlap=args.overlap)
            _sync(eng.device)
            dt = (time.perf_counter() - t0) / k
            for rec in eng.history[-k:]:
                print(f"round {rec['round'] - 1:3d}  loss {rec['loss']:.4f}"
                      f"  {dt:.2f}s/round", flush=True)
                out.append(dict(rec, seconds=dt))
        done += k
    return out


def run_local(args) -> list[dict]:
    """``--mode local``: SGD steps of one model on one batch."""
    cfg, device = _config(args)
    params = model_init(cfg, generator(device, args.seed), device)
    print(f"params: {param_count(params):,}")
    gen = generator(device, args.seed + 1)
    batch = lm_open_batch(gen, args.batch, args.seq, cfg.vocab)
    batch.update(extra_inputs(cfg, args.batch, gen))
    out = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, loss = sgd_train_step(cfg, params, batch, args.lr)
        loss = float(loss)
        dt = time.perf_counter() - t0
        print(f"step {i:3d}  loss {loss:.4f}  {dt:.2f}s", flush=True)
        out.append({"step": i + 1, "loss": loss, "seconds": dt})
    if args.ckpt:
        save_pytree(args.ckpt, params)
        print("saved", args.ckpt)
    return out


def run(args, mesh=None) -> list[dict]:
    """Run the mode (the federated ones over ``mesh``, if given); returns
    one record a round (or step)."""
    if args.mode == "local":
        if mesh is not None:
            raise ValueError("--mode local trains one model; --world needs "
                             "a federated mode")
        return run_local(args)
    if mesh is not None and args.ckpt and (args.participation < 1.0
                                           or args.straggler is not None):
        raise ValueError("--ckpt of a simulated run over --world is not "
                         "supported: the simulator's books file has no "
                         "single writer yet")
    fed = setup(args, mesh)
    recs = run_rounds(fed, args.steps)
    if args.ckpt:
        if fed.runner is not None:
            fed.runner.save_state(args.ckpt, fed.state)   # + .sim.json
        else:
            fed.engine.save_state(args.ckpt, fed.state)
        print("saved", args.ckpt)
    return recs


if __name__ == "__main__":
    main()
