"""K1/K2: the fused ERA kernels (mean or weighted mean over the client axis,
then a temperature softmax), with their plain PyTorch versions.

The CUDA kernels are in ``csrc/era_sharpen.cu`` (one block per output row,
the row's aggregate in shared memory, fp32 accumulation over k in order).
A wrapper given a CPU tensor computes the plain version; given a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

F32 = torch.float32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SMEM_BYTES = 232_448 - 32 * 4      # the block's limit less the reduction scratch
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "era_sharpen": [_VP, _VP, _CI, _CI, _CI, _CI, _CF, _CF, _VP],
    "weighted_era_sharpen": [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CF, _CI, _VP],
}


def _lib() -> ctypes.CDLL:
    return _build.library("era_sharpen", _SIGNATURES)


def _softmax_rows(s: torch.Tensor) -> torch.Tensor:
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / e.sum(dim=-1, keepdim=True)


def era_sharpen_plain(local_probs: torch.Tensor,
                      temperature: float) -> torch.Tensor:
    """(K, N, C) -> (N, C) f32: the kernel's arithmetic in plain PyTorch."""
    K = local_probs.shape[0]
    s = local_probs.to(F32).sum(dim=0) * (1.0 / K) * (1.0 / temperature)
    return _softmax_rows(s)


def weighted_era_sharpen_plain(local_probs: torch.Tensor, weights: torch.Tensor,
                               temperature: float = 0.1,
                               sharpen: bool = True) -> torch.Tensor:
    """(K, N, C) x (K,) normalized weights -> (N, C) f32."""
    w = weights.to(F32).reshape(-1, 1, 1)
    acc = (local_probs.to(F32) * w).sum(dim=0)
    if not sharpen:
        return acc
    return _softmax_rows(acc * (1.0 / temperature))


def _check_probs(p: torch.Tensor, what: str):
    _build.require_cuda(p, what)
    if p.ndim != 3:
        raise ValueError(f"{what}: expected (K, N, C), got {tuple(p.shape)}")
    if p.dtype not in _DTYPE_CODE:
        raise ValueError(f"{what}: dtype {p.dtype} not supported "
                         f"(float32 or bfloat16)")
    if not p.is_contiguous():
        raise ValueError(f"{what}: probabilities must be contiguous")
    K, N, C = p.shape
    if K == 0 or N == 0 or C == 0:
        raise ValueError(f"{what}: empty shape {tuple(p.shape)}")
    if C * 4 > SMEM_BYTES:
        raise ValueError(f"{what}: C={C} classes need {C * 4} bytes of shared "
                         f"memory per row, above the block limit {SMEM_BYTES}")
    return K, N, C


def era_sharpen(local_probs: torch.Tensor, temperature: float) -> torch.Tensor:
    """K1.  (K, N, C) f32 or bf16 -> (N, C) f32:
    ``softmax((sum_k p_k) * (1/K) / T)``."""
    if local_probs.device.type == "cpu":
        return era_sharpen_plain(local_probs, temperature)
    K, N, C = _check_probs(local_probs, "era_sharpen")
    out = torch.empty((N, C), dtype=F32, device=local_probs.device)
    lib = _lib()
    err = lib.era_sharpen(_build.ptr(local_probs), _build.ptr(out), K, N, C,
                          _DTYPE_CODE[local_probs.dtype], 1.0 / K,
                          1.0 / temperature, _build.stream_of(out))
    _build.check(lib, err, "era_sharpen")
    _build.LAUNCHES["era_sharpen"] += 1
    return out


def weighted_era_sharpen(local_probs: torch.Tensor, weights: torch.Tensor,
                         temperature: float = 0.1,
                         sharpen: bool = True) -> torch.Tensor:
    """K2.  (K, N, C) f32 or bf16 x (K,) normalized f32 weights -> (N, C)
    f32: ``softmax(sum_k w_k p_k / T)``, or the weighted mean itself with
    ``sharpen=False``.  A zero-weight client changes no bit."""
    if local_probs.device.type == "cpu":
        return weighted_era_sharpen_plain(local_probs, weights, temperature,
                                          sharpen)
    K, N, C = _check_probs(local_probs, "weighted_era_sharpen")
    if (weights.shape != (K,) or weights.dtype != F32
            or weights.device != local_probs.device
            or not weights.is_contiguous()):
        raise ValueError(f"weighted_era_sharpen: weights must be a contiguous "
                         f"({K},) float32 tensor on {local_probs.device}, got "
                         f"{tuple(weights.shape)} {weights.dtype} on "
                         f"{weights.device}")
    out = torch.empty((N, C), dtype=F32, device=local_probs.device)
    lib = _lib()
    err = lib.weighted_era_sharpen(
        _build.ptr(local_probs), _build.ptr(weights), _build.ptr(out), K, N, C,
        _DTYPE_CODE[local_probs.dtype], 1.0 / temperature, int(sharpen),
        _build.stream_of(out))
    _build.check(lib, err, "weighted_era_sharpen")
    _build.LAUNCHES["weighted_era_sharpen"] += 1
    return out
