"""Sharding contexts the models read: the reference's activation-sharding
context (``repro/models/shardctx.py``) and the tensor-parallel plan of the
round in progress.

Code calls ``constrain(x, "batch", None, "model")`` at layer boundaries.
Outside an `axis_ctx`, or on a plain tensor, it returns ``x`` unchanged; on
a DTensor inside one it redistributes ``x`` to the placements its dims
name, with the reference's divisibility guards.  In the reference these
constraints stop GSPMD from solving FSDP weight shardings with
activation-sized all-reduces.  Here only `core.llm_dsfl` calls it (the
top-k densify and its teacher); the models run their layouts with
explicit collectives instead, on plain tensors:

`active_plan(plan)` makes a plan (`launch.tp.TPPlan`: the flags saying
which layers the mesh splits, and the "data" and "model" groups, which
carry their collectives) the one the models read through `current_plan`,
and this module holds Megatron's collectives as autograd functions over
those groups: the identity whose backward all-reduces (`_CopyToModel`),
the all-reduce whose backward is the identity (`_ReduceFromModel`), the
"model" all-gather of a column-parallel output whose backward keeps the
rank's columns (`gather_columns`: the VLM's projector; `gather_vocab`:
the logits), the "model" all-gather whose backward reduce-scatters
(`gather_model_sum`: a column split the Mamba2 mixer reads whole on every
rank, B and C), the all-reduce whose backward all-reduces too
(`all_reduce_both`: a partial sum whose uses differ by rank, the gated
norm's sum of squares), FSDP's gather whose backward reduce-scatters
(`_GatherData`: `gather_block`, `gather_top`), and the identity whose
backward sums over "data" (`_SumOverData`), and the decode step's merge
of a ring split over ranks (`ring_merge`).  The plan is process-wide, not
thread-local: a block's recompute runs on autograd's thread inside the
round that set it.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from ..launch.mesh import axis_sizes
from ..launch.sharding import stack_of

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


# ------------------------------------------------- tensor-parallel plan ----
_PLAN = None


@contextlib.contextmanager
def active_plan(plan):
    """Make ``plan`` the one the models read while the block runs (None:
    no change of layout)."""
    global _PLAN
    prev, _PLAN = _PLAN, plan
    try:
        yield
    finally:
        _PLAN = prev


def current_plan():
    return _PLAN


class _CopyToModel(torch.autograd.Function):
    """The identity; its backward all-reduces the gradient over "model"
    (the input of a column-parallel region: Megatron's f)."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.all_reduce(grad.contiguous().clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """The all-reduce over "model" of a row-parallel product's partial
    sums; its backward is the identity (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, g):
        return g.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """The ranks' columns (last dimension) of a column-parallel output
    gathered into whole rows, which every rank then uses alike; the
    backward keeps the rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g, ctx.n = g, x.shape[-1]
        return g.all_gather(x, x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        g, n = ctx.g, ctx.n
        return grad.narrow(-1, g.rank * n, n).contiguous(), None


class _GatherModelSum(torch.autograd.Function):
    """The ranks' columns (last dimension) gathered whole over "model";
    every rank uses all of them, so the backward reduce-scatters: each
    rank's columns get the sum of every rank's gradient of them."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return g.all_gather(x, x.dim() - 1)

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.reduce_scatter(grad, grad.dim() - 1), None


class _AllReduceBoth(torch.autograd.Function):
    """The all-reduce over "model" of partial sums whose result each rank
    uses in its own way: the backward all-reduces the gradient as well."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return g.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.all_reduce(grad.contiguous().clone()), None


class _GatherData(torch.autograd.Function):
    """An FSDP leaf gathered whole over "data" along ``dim``; the backward
    reduce-scatters its gradient back onto the shards."""

    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return g.all_gather(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.reduce_scatter(grad, ctx.dim), None, None


class _SumOverData(torch.autograd.Function):
    """A leaf "data" replicates: the identity, its gradient all-reduced
    over "data"."""

    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.g.all_reduce(grad.contiguous().clone()), None


def gather_columns(plan, x: torch.Tensor) -> torch.Tensor:
    return _GatherColumns.apply(x, plan.model)


def copy_to_model(plan, x: torch.Tensor) -> torch.Tensor:
    return _CopyToModel.apply(x, plan.model)


def reduce_model(plan, x: torch.Tensor) -> torch.Tensor:
    return _ReduceFromModel.apply(x, plan.model)


def gather_model_sum(plan, x: torch.Tensor) -> torch.Tensor:
    return _GatherModelSum.apply(x, plan.model)


def all_reduce_both(plan, x: torch.Tensor) -> torch.Tensor:
    return _AllReduceBoth.apply(x, plan.model)


def _data_leaf(plan, name: str, v: torch.Tensor) -> torch.Tensor:
    dim = plan.data_dims[name]
    if dim is None:
        return _SumOverData.apply(v, plan.data)
    return _GatherData.apply(v, plan.data, dim)


def gather_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Whole-vocabulary logits from the rank's columns (the identity
    without a plan or where the vocabulary is replicated)."""
    plan = _PLAN
    if plan is None or not plan.vocab_tp:
        return logits
    return gather_columns(plan, logits)


def gather_block(bp: dict, stack: str = "blocks") -> dict:
    """One block of the stack ``stack`` (``blocks``, or the
    encoder-decoder's ``enc``, ``dec``; or a sub-layer's prefix in one,
    ``dec/cross``) with its leaves (``s0_mix/wq``, ``cross/wk``, ...) whole
    on "data" (`_GatherData`) or summing their gradients over it."""
    plan = _PLAN
    if plan is None or plan.data.size == 1:
        return bp
    return {k: _data_leaf(plan, f"{stack}/{k}", v) for k, v in bp.items()}


def gather_top(params: dict) -> dict:
    """``params`` with its leaves outside the stacks whole on "data" (a
    stack's stay sharded: `gather_block` takes them one block at a
    time)."""
    plan = _PLAN
    if plan is None or plan.data.size == 1:
        return params
    return {k: (v if stack_of(k) else _data_leaf(plan, k, v))
            for k, v in params.items()}


def ring_merge(plan, ring, m: torch.Tensor, l: torch.Tensor,
               acc: torch.Tensor) -> torch.Tensor:
    """Attention over a ring whose slots lie on several ranks
    (``ring.axes``, `launch.tp.Ring`), from each rank's statistics of its
    slots: the row maxima ``m`` (..., 1) f32, the sums of ``exp(s - m)``
    ``l`` (...,) and the exp-weighted values ``acc`` (..., hd) f32.  The
    maxima are all-reduced (max) over the ring's axes, each rank rescales
    its sums to the global maximum, and the sums and values are all-reduced
    together: the online softmax's (max, sum) merge.  Returns the
    normalized output (..., hd) f32."""
    groups = [{"data": plan.data, "model": plan.model}[a] for a in ring.axes]
    g_max = m.clone()
    for g in groups:
        g_max = g.all_reduce_max(g_max)
    scale = torch.exp(m - g_max)
    both = torch.cat([acc * scale, (l[..., None] * scale)], dim=-1)
    for g in groups:
        both = g.all_reduce(both.contiguous())
    return both[..., :-1] / both[..., -1:]
