"""Activation-sharding context (mirrors ``repro/models/shardctx.py``).

Code calls ``constrain(x, "batch", None, "model")`` at layer boundaries.
Outside an `axis_ctx`, or on a plain tensor, it returns ``x`` unchanged; on
a DTensor inside one it redistributes ``x`` to the placements its dims
name, with the reference's divisibility guards.  In the reference these
constraints stop GSPMD from solving FSDP weight shardings with
activation-sized all-reduces.  Here only `core.llm_dsfl` calls it (the
top-k densify and its teacher); the models' calls come with tensor-parallel
execution.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..launch.mesh import axis_sizes

_tls = threading.local()


def _state():
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def axis_ctx(mesh, batch_axes=("data",), model_axis="model"):
    """The launcher's context: the mesh, and the axis names and sizes the
    divisibility guards read."""
    sizes = axis_sizes(mesh)
    prev = _state()
    batch_size = 1
    for a in batch_axes:
        batch_size *= sizes.get(a, 1)
    _tls.ctx = {"mesh": mesh, "batch": tuple(batch_axes),
                "batch_size": batch_size, "model": model_axis,
                "model_size": sizes.get(model_axis, 1)}
    try:
        yield
    finally:
        _tls.ctx = prev


def spec_of(x_shape, *dims) -> tuple:
    """The spec ``constrain`` asks for: per dimension, the batch axes for
    "batch" and the model axis for "model" where the size divides by the
    axes' product (and that product is above 1), else None."""
    ctx = _state()
    spec = []
    for d, size in zip(dims, x_shape):
        if (d == "batch" and ctx["batch_size"] > 1
                and size % ctx["batch_size"] == 0):
            spec.append(ctx["batch"] if len(ctx["batch"]) > 1
                        else ctx["batch"][0])
        elif (d == "model" and ctx["model_size"] > 1
                and size % ctx["model_size"] == 0):
            spec.append(ctx["model"])
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x: torch.Tensor, *dims):
    """dims: "batch" | "model" | None per dimension of ``x``."""
    from torch.distributed.tensor import DTensor
    ctx = _state()
    if ctx is None or not isinstance(x, DTensor):
        return x
    from ..launch.sharding import to_placements
    mesh = ctx["mesh"]
    return x.redistribute(mesh, to_placements(mesh, spec_of(x.shape, *dims)))
