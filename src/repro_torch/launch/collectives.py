"""The collectives of the federated-client axis, over the mesh's "pod"
group: the few that XLA inserts for the reference's pod-sharded client
axis, made explicit.

  * `all_gather_clients` -- each rank's (n, ...) lanes into the (P*n, ...)
    stack in rank (client) order;
  * `all_reduce_sum` -- the element-wise sum over the ranks, in place;
  * `all_gather_clients_async` / `all_reduce_sum_async` -- the same
    issued with ``async_op``, returning a `Pending` whose ``wait()``
    gives the result.

Every call appends ``(kind, axes, nbytes)`` to `LOG`: ``kind`` the
reference's HLO name ("all-gather", "all-reduce"), ``axes`` the mesh axes
the group spans with more than one rank (("pod",), or () on a one-rank
pod, where the call moves nothing), ``nbytes`` the bytes of the per-rank
result, the reference's ``collective_bytes`` convention.  `log` reads it
and `reset_log` clears it; `launch.roofline` sums it.  A failed collective
raises: nothing is retried or skipped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from .mesh import axis_size, axis_sizes

AXIS = "pod"
LOG: list = []


def log() -> list:
    """The entries since the last `reset_log`, oldest first."""
    return list(LOG)


def reset_log() -> None:
    LOG.clear()


@dataclass
class PodGroup:
    """The "pod" axis of a mesh as seen from this rank: its process group,
    this rank's index on it and its size."""
    group: object
    rank: int
    size: int


def pod_group(mesh) -> PodGroup:
    """The "pod" group of ``mesh`` (a ``DeviceMesh``).  Its "data" and
    "model" axes must have size 1 here: executing them is a later slice
    (tensor-parallel and FSDP execution over DTensor)."""
    if AXIS not in axis_sizes(mesh):
        raise ValueError(f"mesh axes {tuple(axis_sizes(mesh))} have no "
                         f"{AXIS!r} axis to put the clients on")
    for ax in ("data", "model"):
        if axis_size(mesh, ax) > 1:
            raise NotImplementedError(
                f"mesh axis {ax!r} has size {axis_size(mesh, ax)}: this "
                f"slice runs only the federated-client axis 'pod'; tensor "
                f"parallelism and FSDP over 'model' and 'data' come with "
                f"the DTensor execution slice")
    return PodGroup(mesh.get_group(AXIS), mesh.get_local_rank(AXIS),
                    axis_size(mesh, AXIS))


def _record(kind: str, pg: PodGroup, result: torch.Tensor) -> None:
    LOG.append((kind, (AXIS,) if pg.size > 1 else (),
                result.numel() * result.element_size()))


@dataclass
class Pending:
    """An issued collective; ``wait()`` blocks until it is done and
    returns its result."""
    work: object
    finish: Callable[[], torch.Tensor]

    def wait(self) -> torch.Tensor:
        self.work.wait()
        return self.finish()


def _gather(x: torch.Tensor, pg: PodGroup, async_op: bool):
    x = x.contiguous()
    out = torch.empty((pg.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    work = dist.all_gather(list(out.chunk(pg.size)), x, group=pg.group,
                           async_op=async_op)
    _record("all-gather", pg, out)
    return work, out


def all_gather_clients(x: torch.Tensor, pg: PodGroup) -> torch.Tensor:
    """(n, ...) on each rank -> (P*n, ...), rank r's lanes at [r*n, (r+1)*n)."""
    return _gather(x, pg, False)[1]


def all_gather_clients_async(x: torch.Tensor, pg: PodGroup) -> Pending:
    work, out = _gather(x, pg, True)
    return Pending(work, lambda: out)


def all_reduce_sum(x: torch.Tensor, pg: PodGroup) -> torch.Tensor:
    """The sum of ``x`` over the ranks, written into ``x`` (contiguous)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=pg.group)
    _record("all-reduce", pg, x)
    return x


def all_reduce_sum_async(x: torch.Tensor, pg: PodGroup) -> Pending:
    work = dist.all_reduce(x, op=dist.ReduceOp.SUM, group=pg.group,
                           async_op=True)
    _record("all-reduce", pg, x)
    return Pending(work, lambda: x)
