"""Starting a ``torch.distributed`` world: each rank's process group, its
device, and a launcher that spawns the ranks itself.

`spawn(fn, world, *args)` starts ``world`` processes with
``torch.multiprocessing`` (the ``spawn`` method: each child imports the
package afresh, so ``fn`` must be importable, a module-level function of
the package), joins each to a group rendezvousing through a ``FileStore``
under ``build/dist/`` at the root of the checkout (no port is opened for
the rendezvous), calls ``fn(rank, world, *args)`` and returns each rank's
result in rank order.  A rank that raises exits, and the spawn stops the
other ranks and raises.

Under ``torchrun``, `init_from_env` reads ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` and joins through torchrun's own store.  The backend is
what the caller names ("nccl" or "gloo"); nothing switches it.
`rank_device` puts a rank on ``cuda:LOCAL_RANK % device_count`` (two
ranks share the one card with gloo: NCCL refuses two ranks on one device)
or on the CPU when asked; without a card a CUDA rank raises.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from ..device import resolve_device

STORE_ROOT = Path(__file__).resolve().parents[3] / "build" / "dist"


def rank_device(device, local_rank: int, local_world: int = 1
                ) -> torch.device:
    """This rank's device: ``device``'s type, on card
    ``local_rank % device_count`` for CUDA (and made current there).  On
    the CPU the ``local_world`` ranks of the host split its threads."""
    d = resolve_device(device)
    if d.type != "cuda":
        torch.set_num_threads(max(1, torch.get_num_threads() // local_world))
        return d
    d = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(d)
    return d


def init_rank(rank: int, world: int, backend: str, store_path: str) -> None:
    """Join the ``world``-rank group through the file store at
    ``store_path`` (NCCL works on the card `rank_device` made current)."""
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)


def init_from_env(backend: str, device="cuda") -> tuple[int, int, torch.device]:
    """Join the group torchrun set up; returns (rank, world, device)."""
    local = int(os.environ["LOCAL_RANK"])
    dev = rank_device(device, local,
                      int(os.environ.get("LOCAL_WORLD_SIZE", "1")))
    dist.init_process_group(backend)
    return dist.get_rank(), dist.get_world_size(), dev


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ \
        and "LOCAL_RANK" in os.environ


def close() -> None:
    """Leave the group after a run every rank finished (a barrier first,
    so no rank tears down a collective another still waits on).  A rank
    that failed does not call it: it exits, and the launcher stops the
    others."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _entry(rank: int, fn, world: int, backend: str, store_path: str,
           out_dir: str, args: tuple) -> None:
    init_rank(rank, world, backend, store_path)
    result = fn(rank, world, *args)
    torch.save(result, os.path.join(out_dir, f"result.{rank}.pt"))
    close()


def rank_programs(rank: int, world: int, programs: tuple) -> list:
    """Several rank programs in turn on one spawned rank (one spawn, one
    group): each a (function, arguments) pair, called as
    ``function(rank, world, *arguments)``; returns their results."""
    return [fn(rank, world, *args) for fn, args in programs]


def spawn(fn, world: int, *args, backend: str = "gloo") -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks joined
    over ``backend``; returns their results, rank 0's first."""
    import torch.multiprocessing as mp
    STORE_ROOT.mkdir(parents=True, exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="run-", dir=STORE_ROOT)
    try:
        mp.start_processes(
            _entry, args=(fn, world, backend,
                          os.path.join(run_dir, "store"), run_dir, args),
            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(run_dir, f"result.{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
