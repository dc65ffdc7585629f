"""The collectives the reference's XLA programs insert, made explicit over
the groups of a ``("pod", "data", "model")`` mesh: "pod" carries the
federated clients, "data" FSDP and data parallelism, "model" Megatron
tensor parallelism (`launch.tp`).

  * `all_gather_clients` -- each rank's (n, ...) lanes into the (P*n, ...)
    stack in rank (client) order;
  * `all_gather` -- the ranks' pieces concatenated along any dimension;
  * `all_reduce_sum` -- the element-wise sum over the ranks, in place;
  * `all_reduce_max` -- the element-wise maximum, in place (a decode
    ring's merge over ranks: `models.shardctx.ring_merge`);
  * `reduce_scatter_sum` -- that sum, each rank keeping its piece along a
    dimension (gloo, which has no reduce-scatter for CUDA tensors, runs it
    as a whole all-reduce and a slice there; the log records the
    reduce-scatter the program asks for, with its result's bytes, not the
    all-reduce that ran);
  * `all_gather_clients_async` / `all_reduce_sum_async` -- issued with
    ``async_op``, returning a `Pending` whose ``wait()`` gives the result.

Every call appends ``(kind, axes, nbytes)`` to `LOG`: ``kind`` the
reference's HLO name ("all-gather", "all-reduce", "reduce-scatter"),
``axes`` the mesh axis the group spans when it has more than one rank
(("pod",), ("data",) or ("model",); () on a one-rank group, where the call
moves nothing), ``nbytes`` the bytes of the per-rank result, the
reference's ``collective_bytes`` convention.  `log` reads it and
`reset_log` clears it; `launch.roofline` sums it.  A failed collective
raises: nothing is retried or skipped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from .mesh import axis_size, axis_sizes

AXES = ("pod", "data", "model")
LOG: list = []


def log() -> list:
    """The entries since the last `reset_log`, oldest first."""
    return list(LOG)


def reset_log() -> None:
    LOG.clear()


@dataclass
class AxisGroup:
    """One axis of a mesh as seen from this rank: its process group, this
    rank's index on it, its size and the axis' name."""
    group: object
    rank: int
    size: int
    axis: str = "pod"

    # the collectives over this group, for code that holds the group but
    # not this module (`models.shardctx`)
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(x, self)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return all_gather(x, self, dim)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        return reduce_scatter_sum(x, self, dim)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce_max(x, self)


def axis_group(mesh, axis: str) -> AxisGroup:
    """The group of ``mesh``'s axis ``axis`` (a ``DeviceMesh``) holding
    this rank: the ranks that differ from it only along ``axis``."""
    if axis not in axis_sizes(mesh):
        raise ValueError(f"mesh axes {tuple(axis_sizes(mesh))} have no "
                         f"{axis!r} axis")
    return AxisGroup(mesh.get_group(axis), mesh.get_local_rank(axis),
                     axis_size(mesh, axis), axis)


def pod_group(mesh) -> AxisGroup:
    """The "pod" group of ``mesh``, which the federated clients lie on."""
    if "pod" not in axis_sizes(mesh):
        raise ValueError(f"mesh axes {tuple(axis_sizes(mesh))} have no "
                         f"'pod' axis to put the clients on")
    return axis_group(mesh, "pod")


def _record(kind: str, g: AxisGroup, result: torch.Tensor) -> None:
    LOG.append((kind, (g.axis,) if g.size > 1 else (),
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


def _gather(x: torch.Tensor, pg: AxisGroup, async_op: bool):
    x = x.contiguous()
    out = torch.empty((pg.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    work = dist.all_gather(list(out.chunk(pg.size)), x, group=pg.group,
                           async_op=async_op)
    _record("all-gather", pg, out)
    return work, out


def all_gather_clients(x: torch.Tensor, pg: AxisGroup) -> torch.Tensor:
    """(n, ...) on each rank -> (P*n, ...), rank r's lanes at [r*n, (r+1)*n)."""
    return _gather(x, pg, False)[1]


def all_gather(x: torch.Tensor, g: AxisGroup, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    if dim == 0:
        return _gather(x, g, False)[1]
    out = _gather(x.movedim(dim, 0), g, False)[1]
    return out.movedim(0, dim).contiguous()


def reduce_scatter_sum(x: torch.Tensor, g: AxisGroup, dim: int
                       ) -> torch.Tensor:
    """Rank r's piece along ``dim`` of the sum of ``x`` over the ranks."""
    n = x.shape[dim] // g.size
    src = x.movedim(dim, 0).contiguous()
    if x.is_cuda and dist.get_backend(g.group) == "gloo":
        # gloo has no reduce-scatter of CUDA tensors
        out = src.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g.group)
        out = out[g.rank * n:(g.rank + 1) * n]
    else:
        out = torch.empty_like(src[:n])
        dist.reduce_scatter(out, list(src.chunk(g.size)),
                            op=dist.ReduceOp.SUM, group=g.group)
    out = out.movedim(0, dim).contiguous()
    _record("reduce-scatter", g, out)
    return out


def all_gather_clients_async(x: torch.Tensor, pg: AxisGroup) -> Pending:
    work, out = _gather(x, pg, True)
    return Pending(work, lambda: out)


def all_reduce_sum(x: torch.Tensor, pg: AxisGroup) -> torch.Tensor:
    """The sum of ``x`` over the ranks, written into ``x`` (contiguous)."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=pg.group)
    _record("all-reduce", pg, x)
    return x


def all_reduce_max(x: torch.Tensor, pg: AxisGroup) -> torch.Tensor:
    """The element-wise maximum of ``x`` over the ranks, written into
    ``x`` (contiguous); logged as an "all-reduce"."""
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=pg.group)
    _record("all-reduce", pg, x)
    return x


def all_reduce_sum_async(x: torch.Tensor, pg: AxisGroup) -> Pending:
    work = dist.all_reduce(x, op=dist.ReduceOp.SUM, group=pg.group,
                           async_op=True)
    _record("all-reduce", pg, x)
    return Pending(work, lambda: x)
