"""K1-K5 as ``torch.library`` ops in the namespace ``repro_torch``.

  * ``torch.ops.repro_torch.era_sharpen(p, T)`` -- K1;
  * ``torch.ops.repro_torch.weighted_era_sharpen(p, w, T, sharpen)`` -- K2;
  * ``torch.ops.repro_torch.distill_loss_fwd(z, t)`` -- K3;
  * ``torch.ops.repro_torch.distill_loss_bwd(z, t, logz, tmass, gscale)``
    -- K4 (the backward of `kernels.ops.distill_loss_2d`, whose gradient
    flows to z only);
  * ``torch.ops.repro_torch.ssd_chunk(x, dt, dA, B, C)`` -- K5.

Each op has three implementations: CUDA, the kernel's launch (the
``launch_*`` function of its module, which counts the launch in
`_build.LAUNCHES` right after it and nowhere else); CPU, the kernel's
plain version; and a fake one (``register_fake``), which runs the checks
that need no pointer and gives the outputs' shapes and dtypes, so a
``FakeTensorMode`` trace of a step (`launch.costs`, `launch.dryrun`) sees
one op where the card launches one kernel.

The FLOP formulas (``register_flop_formula``, read by ``FlopCounterMode``)
count tensor-core work, as ``FlopCounterMode`` does for a matmul: K5 its
two products, ``2 Q^2 N`` a chunk and group for ``C B^T`` and ``2 Q^2 P``
a chunk and head for the product with x.  K1-K4 count 0: they bring no
matmul, and their elementwise work enters a roofline through its bytes.
`op_bytes` gives each op's bytes: its inputs read once and its outputs
written once (`PERF.md`'s "bound (bytes)" convention).
"""
from __future__ import annotations

import math

import torch
from torch import Tensor
from torch.library import custom_op, register_fake
from torch.utils.flop_counter import register_flop_formula

from . import distill_loss as _dl
from . import era_sharpen as _era
from . import ssd_chunk as _ssd

NAMESPACE = "repro_torch"
F32 = torch.float32


# ---------------------------------------------------------------- K1 ------
@custom_op("repro_torch::era_sharpen", mutates_args=(), device_types="cuda")
def era_sharpen(local_probs: Tensor, temperature: float) -> Tensor:
    return _era.launch_era_sharpen(local_probs, temperature)


@era_sharpen.register_kernel("cpu")
def _(local_probs, temperature):
    return _era.era_sharpen_plain(local_probs, temperature)


@register_fake("repro_torch::era_sharpen")
def _(local_probs, temperature):
    _, N, C = _era.check_probs(local_probs, "era_sharpen")
    return local_probs.new_empty((N, C), dtype=F32)


# ---------------------------------------------------------------- K2 ------
@custom_op("repro_torch::weighted_era_sharpen", mutates_args=(),
           device_types="cuda")
def weighted_era_sharpen(local_probs: Tensor, weights: Tensor,
                         temperature: float, sharpen: bool) -> Tensor:
    return _era.launch_weighted_era_sharpen(local_probs, weights,
                                            temperature, sharpen)


@weighted_era_sharpen.register_kernel("cpu")
def _(local_probs, weights, temperature, sharpen):
    return _era.weighted_era_sharpen_plain(local_probs, weights, temperature,
                                           sharpen)


@register_fake("repro_torch::weighted_era_sharpen")
def _(local_probs, weights, temperature, sharpen):
    _, N, C = _era.check_probs(local_probs, "weighted_era_sharpen")
    _era.check_weights(weights, local_probs)
    return local_probs.new_empty((N, C), dtype=F32)


# ---------------------------------------------------------------- K3 ------
@custom_op("repro_torch::distill_loss_fwd", mutates_args=(),
           device_types="cuda")
def distill_loss_fwd(z: Tensor, t: Tensor) -> tuple[Tensor, Tensor]:
    return _dl.launch_distill_loss_fwd(z, t)


@distill_loss_fwd.register_kernel("cpu")
def _(z, t):
    return _dl.distill_loss_fwd_plain(z, t)


@register_fake("repro_torch::distill_loss_fwd")
def _(z, t):
    N, _ = _dl.check_pair(z, t, "distill_loss_fwd")
    return z.new_empty((N,), dtype=F32), z.new_empty((N,), dtype=F32)


# ---------------------------------------------------------------- K4 ------
@custom_op("repro_torch::distill_loss_bwd", mutates_args=(),
           device_types="cuda")
def distill_loss_bwd(z: Tensor, t: Tensor, logz: Tensor, tmass: Tensor,
                     gscale: Tensor) -> Tensor:
    return _dl.launch_distill_loss_bwd(z, t, logz, tmass, gscale)


@distill_loss_bwd.register_kernel("cpu")
def _(z, t, logz, tmass, gscale):
    return _dl.distill_loss_bwd_plain(z, t, logz, tmass, gscale)


@register_fake("repro_torch::distill_loss_bwd")
def _(z, t, logz, tmass, gscale):
    _dl.check_bwd(z, t, logz, tmass, gscale)
    return torch.empty_like(z)


# ---------------------------------------------------------------- K5 ------
@custom_op("repro_torch::ssd_chunk", mutates_args=(), device_types="cuda")
def ssd_chunk(x: Tensor, dt: Tensor, dA: Tensor, Bm: Tensor,
              Cm: Tensor) -> Tensor:
    return _ssd.launch_ssd_chunk(x, dt, dA, Bm, Cm)


@ssd_chunk.register_kernel("cpu")
def _(x, dt, dA, Bm, Cm):
    # contiguous, as the kernel writes it (the plain einsum's is not)
    return _ssd.ssd_chunk_plain(x, dt, dA, Bm, Cm).contiguous()


@register_fake("repro_torch::ssd_chunk")
def _(x, dt, dA, Bm, Cm):
    _ssd.check(x, dt, dA, Bm, Cm)
    return x.new_empty(tuple(x.shape), dtype=F32)


# ----------------------------------------------------------- formulas -----
def ssd_chunk_flops(x_shape, b_shape) -> int:
    """K5's tensor-core FLOPs: ``2 Q^2 N`` a chunk and group (the scores
    ``C B^T``) and ``2 Q^2 P`` a chunk and head (their product with x)."""
    M, Q, H, P = x_shape
    G, N = b_shape[2], b_shape[3]
    return 2 * Q * Q * N * M * G + 2 * Q * Q * P * M * H


@register_flop_formula(torch.ops.repro_torch.ssd_chunk)
def _(x_shape, dt_shape, dA_shape, b_shape, c_shape, *args, out_shape=None,
      **kwargs) -> int:
    return ssd_chunk_flops(x_shape, b_shape)


def _no_matmul(*args, out_shape=None, **kwargs) -> int:
    return 0


for _op in (torch.ops.repro_torch.era_sharpen,
            torch.ops.repro_torch.weighted_era_sharpen,
            torch.ops.repro_torch.distill_loss_fwd,
            torch.ops.repro_torch.distill_loss_bwd):
    register_flop_formula(_op)(_no_matmul)

OPS = ("era_sharpen", "weighted_era_sharpen", "distill_loss_fwd",
       "distill_loss_bwd", "ssd_chunk")


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def op_bytes(name: str, *args) -> int:
    """Bytes of one call of op ``name`` on ``args`` (tensors or fake
    tensors): each input read once, each output written once."""
    if name == "era_sharpen":
        p = args[0]
        return _nbytes(p.shape, p.dtype) + _nbytes(p.shape[1:], F32)
    if name == "weighted_era_sharpen":
        p, w = args[:2]
        return (_nbytes(p.shape, p.dtype) + _nbytes(w.shape, w.dtype)
                + _nbytes(p.shape[1:], F32))
    if name == "distill_loss_fwd":
        z, t = args
        return (_nbytes(z.shape, z.dtype) + _nbytes(t.shape, t.dtype)
                + 2 * _nbytes(z.shape[:1], F32))
    if name == "distill_loss_bwd":
        z, t, logz, tmass, gscale = args
        return (2 * _nbytes(z.shape, z.dtype) + _nbytes(t.shape, t.dtype)
                + sum(_nbytes(a.shape, a.dtype) for a in (logz, tmass,
                                                          gscale)))
    if name == "ssd_chunk":
        x = args[0]
        return (sum(_nbytes(a.shape, a.dtype) for a in args)
                + _nbytes(x.shape, F32))
    raise KeyError(f"no op repro_torch::{name}")
