"""K3/K4: the fused distillation cross-entropy CE(t || softmax(z)) per row
and its gradient, with their plain PyTorch versions.

The CUDA kernels are in ``csrc/distill_loss.cu`` (K3: one block per row,
an online logsumexp over the vocabulary in registers; K4: one elementwise
pass).  Any N and V: the tails are masked, nothing is padded.  A wrapper
given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

F32 = torch.float32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "distill_loss_fwd": [_VP, _VP, _VP, _VP, _CI, _CI, _CI, _VP],
    "distill_loss_bwd": [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _VP],
}


def _lib() -> ctypes.CDLL:
    return _build.library("distill_loss", _SIGNATURES)


def distill_loss_fwd_plain(z: torch.Tensor, t: torch.Tensor):
    """(N, V) -> (per-row loss (N,), logZ (N,)) f32, the kernel's arithmetic:
    ``loss = tmass * logZ - sum t*z``."""
    zf, tf = z.to(F32), t.to(F32)
    m = zf.amax(dim=-1, keepdim=True)
    logz = (m + torch.log(torch.exp(zf - m).sum(dim=-1, keepdim=True)))[:, 0]
    return tf.sum(dim=-1) * logz - (tf * zf).sum(dim=-1), logz


def distill_loss_bwd_plain(z, t, logz, tmass, gscale):
    """``gscale * (exp(z - logZ) * tmass - t)`` in z's dtype."""
    p = torch.exp(z.to(F32) - logz[:, None])
    return (gscale[0] * (p * tmass[:, None] - t.to(F32))).to(z.dtype)


def _check_pair(z, t, what: str):
    _build.require_cuda(z, what)
    if z.ndim != 2 or t.shape != z.shape:
        raise ValueError(f"{what}: expected z, t of one (N, V) shape, got "
                         f"{tuple(z.shape)} and {tuple(t.shape)}")
    if z.dtype not in _DTYPE_CODE or t.dtype != z.dtype:
        raise ValueError(f"{what}: z and t must both be float32 or both "
                         f"bfloat16, got {z.dtype} and {t.dtype}")
    if t.device != z.device or not (z.is_contiguous() and t.is_contiguous()):
        raise ValueError(f"{what}: z and t must be contiguous on one device")
    N, V = z.shape
    if N == 0 or V == 0:
        raise ValueError(f"{what}: empty shape {tuple(z.shape)}")
    return N, V


def _check_rows(name: str, a, N: int, device, what: str):
    if a.shape != (N,) or a.dtype != F32 or a.device != device \
            or not a.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous ({N},) float32 "
                         f"tensor on {device}")


def distill_loss_fwd(z: torch.Tensor, t: torch.Tensor):
    """K3.  z, t: (N, V) f32 or bf16 -> (per-row loss (N,), logZ (N,)) f32."""
    if z.device.type == "cpu":
        return distill_loss_fwd_plain(z, t)
    N, V = _check_pair(z, t, "distill_loss_fwd")
    loss = torch.empty((N,), dtype=F32, device=z.device)
    logz = torch.empty((N,), dtype=F32, device=z.device)
    lib = _lib()
    err = lib.distill_loss_fwd(_build.ptr(z), _build.ptr(t), _build.ptr(loss),
                               _build.ptr(logz), N, V, _DTYPE_CODE[z.dtype],
                               _build.stream_of(z))
    _build.check(lib, err, "distill_loss_fwd")
    _build.LAUNCHES["distill_loss_fwd"] += 1
    return loss, logz


def distill_loss_bwd(z, t, logz, tmass, gscale):
    """K4.  Gradient of the mean loss wrt z: ``gscale * (softmax(z) * tmass -
    t)`` in z's dtype.  ``gscale`` is a (1,) f32 tensor on z's device, read
    by the kernel, so the caller need not bring it to the host."""
    if z.device.type == "cpu":
        return distill_loss_bwd_plain(z, t, logz, tmass, gscale)
    N, V = _check_pair(z, t, "distill_loss_bwd")
    _check_rows("logz", logz, N, z.device, "distill_loss_bwd")
    _check_rows("tmass", tmass, N, z.device, "distill_loss_bwd")
    _check_rows("gscale", gscale, 1, z.device, "distill_loss_bwd")
    dz = torch.empty_like(z)
    lib = _lib()
    err = lib.distill_loss_bwd(_build.ptr(z), _build.ptr(t), _build.ptr(logz),
                               _build.ptr(tmass), _build.ptr(gscale),
                               _build.ptr(dz), N, V, _DTYPE_CODE[z.dtype],
                               _build.stream_of(z))
    _build.check(lib, err, "distill_loss_bwd")
    _build.LAUNCHES["distill_loss_bwd"] += 1
    return dz
