"""K3/K4: the fused distillation cross-entropy CE(t || softmax(z)) per row
and its gradient, with their plain PyTorch versions.

The CUDA kernels are in ``csrc/distill_loss.cu``.  K3: one block a long
row, where a thread loads four 16-byte vectors of z and four of t (where
the pointers allow) before it uses any; a row that does not start on a
vector boundary takes a scalar head and tail around its vector body;
short rows share a warp, L lanes a row.  `launch_plan` picks all of that
from the shape.  K4: one
elementwise pass.  Any N and V: nothing is padded.  The wrappers call the
ops of `kernels.library`: CPU tensors take the plain versions, CUDA
tensors the kernels (or an exception), fake tensors the fake
implementations.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build

F32 = torch.float32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
H100_SMS = 132
THREADS = 256          # at most (csrc kMaxThreads)
BATCH_BYTES = 64       # bytes of z, and of t, a thread loads at once (csrc kBatchBytes)
SHORT_BATCH = 4        # elements a lane of a short row loads at once (csrc kShortBatch)
SHORT_V = 16 * SHORT_BATCH   # rows up to this many elements share a warp
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PLAN = [_CI] * 3      # vec, lanes, threads
_SIGNATURES = {
    "distill_loss_fwd": [_VP, _VP, _VP, _VP, _CI, _CI, _CI, *_PLAN, _VP],
    "distill_loss_bwd": [_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _VP],
}


@dataclass(frozen=True)
class LaunchPlan:
    vec: int             # elements a load of the row's body reads (1 for short rows)
    lanes: int           # threads of a row in a block: L < 32 for short rows, else all
    threads: int

    def args(self):
        return (self.vec, self.lanes, self.threads)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pointer_align(z: torch.Tensor, t: torch.Tensor) -> int:
    """The largest power of two (at most 256) that divides the distance
    between the two pointers: a load that wide keeps both aligned once a
    row's head has brought z to a boundary."""
    d = abs(z.data_ptr() - t.data_ptr())
    return min(256, d & -d) if d else 256


def launch_plan(N: int, V: int, dtype=torch.float32, ptr_align: int = 256,
                n_sms: int = H100_SMS) -> LaunchPlan:
    """The kernel's launch for contiguous (N, V) z and t whose pointers lie
    a multiple of ``ptr_align`` bytes apart (`pointer_align`).

    - Short rows (V <= SHORT_V): L lanes a row, the power of two that gives
      each lane at most SHORT_BATCH elements, scalar loads; the threads
      spread the rows over the SMs, 32 to THREADS.
    - Long rows: one block a row; the load width is the widest of 16, 8, 4
      and 2 bytes (one element at least) that divides ``ptr_align``; the
      threads aim at one batch of BATCH_BYTES of z each, 32 to THREADS."""
    elt = 4 if dtype == torch.float32 else 2
    if V <= SHORT_V:
        L = 1
        while L * SHORT_BATCH < V:
            L *= 2
        T = min(THREADS, max(32, _round_up(-(-N * L // n_sms), 32)))
        return LaunchPlan(1, L, T)
    vb = next(b for b in (16, 8, 4, 2, elt) if b >= elt and ptr_align % b == 0)
    vec = vb // elt
    per_batch = BATCH_BYTES // vb          # vectors a thread loads at once
    T = min(THREADS, max(32, _round_up(-(-(V // vec) // per_batch), 32)))
    return LaunchPlan(vec, T, T)


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


def check_pair(z, t, what: str):
    """(N, V) of a pair the kernels take, or ValueError: the checks that
    need no pointer (the fake implementations run them too)."""
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


def check_rows(name: str, a, N: int, device, what: str):
    if a.shape != (N,) or a.dtype != F32 or a.device != device \
            or not a.is_contiguous():
        raise ValueError(f"{what}: {name} must be a contiguous ({N},) float32 "
                         f"tensor on {device}")


def check_bwd(z, t, logz, tmass, gscale):
    N, V = check_pair(z, t, "distill_loss_bwd")
    check_rows("logz", logz, N, z.device, "distill_loss_bwd")
    check_rows("tmass", tmass, N, z.device, "distill_loss_bwd")
    check_rows("gscale", gscale, 1, z.device, "distill_loss_bwd")
    return N, V


def launch_distill_loss_fwd(z: torch.Tensor, t: torch.Tensor):
    """K3's launch on CUDA tensors (the CUDA implementation of
    ``torch.ops.repro_torch.distill_loss_fwd``)."""
    _build.require_cuda(z, "distill_loss_fwd")
    N, V = check_pair(z, t, "distill_loss_fwd")
    plan = launch_plan(N, V, z.dtype, pointer_align(z, t),
                       _build.sm_count(z.device))
    loss = torch.empty((N,), dtype=F32, device=z.device)
    logz = torch.empty((N,), dtype=F32, device=z.device)
    lib = _lib()
    err = lib.distill_loss_fwd(_build.ptr(z), _build.ptr(t), _build.ptr(loss),
                               _build.ptr(logz), N, V, _DTYPE_CODE[z.dtype],
                               *plan.args(), _build.stream_of(z))
    _build.check(lib, err, "distill_loss_fwd")
    _build.LAUNCHES["distill_loss_fwd"] += 1
    return loss, logz


def launch_distill_loss_bwd(z, t, logz, tmass, gscale):
    """K4's launch on CUDA tensors (the CUDA implementation of
    ``torch.ops.repro_torch.distill_loss_bwd``)."""
    _build.require_cuda(z, "distill_loss_bwd")
    N, V = check_bwd(z, t, logz, tmass, gscale)
    dz = torch.empty_like(z)
    lib = _lib()
    err = lib.distill_loss_bwd(_build.ptr(z), _build.ptr(t), _build.ptr(logz),
                               _build.ptr(tmass), _build.ptr(gscale),
                               _build.ptr(dz), N, V, _DTYPE_CODE[z.dtype],
                               _build.stream_of(z))
    _build.check(lib, err, "distill_loss_bwd")
    _build.LAUNCHES["distill_loss_bwd"] += 1
    return dz


def distill_loss_fwd(z: torch.Tensor, t: torch.Tensor):
    """K3.  z, t: (N, V) f32 or bf16 -> (per-row loss (N,), logZ (N,)) f32,
    through the op ``torch.ops.repro_torch.distill_loss_fwd``."""
    _build.require_device(z, "distill_loss_fwd")
    return torch.ops.repro_torch.distill_loss_fwd(z, t)


def distill_loss_bwd(z, t, logz, tmass, gscale):
    """K4.  Gradient of the mean loss wrt z: ``gscale * (softmax(z) * tmass -
    t)`` in z's dtype.  ``gscale`` is a (1,) f32 tensor on z's device, read
    by the kernel, so the caller need not bring it to the host.  Through
    the op ``torch.ops.repro_torch.distill_loss_bwd``."""
    _build.require_device(z, "distill_loss_bwd")
    return torch.ops.repro_torch.distill_loss_bwd(z, t, logz, tmass, gscale)


from . import library  # noqa: E402,F401  (registers the ops)
