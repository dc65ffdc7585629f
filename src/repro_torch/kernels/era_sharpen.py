"""K1/K2: the fused ERA kernels (mean or weighted mean over the client axis,
then a temperature softmax), with their plain PyTorch versions.

The CUDA kernels are in ``csrc/era_sharpen.cu``: a block owns a tile of R
consecutive output rows (one contiguous span of R*C values per client);
threads own 16-byte vectors of that tile where it is aligned (narrower ones
where it is not) and split the client axis into S contiguous slices where
the tile has fewer vectors than threads, so every lane loads and the whole
tile is in flight at once; the slices' fp32 partials are added in order,
then each row is sharpened inside the block.  A row wider than a block's
shared memory (C > 58,080 f32 values) takes the wide-row route instead:
one block a row in two passes, an online (max, sum of exp) in the first,
the sharpened values written in the second.  `launch_plan` picks the route,
R, the vector width, S and the threads from the shape.  The note in the
source gives the bound and the summation order.  The wrappers call the
ops of `kernels.library`: a CPU tensor takes the plain version, a CUDA
tensor the kernel (or an exception), a fake tensor the op's fake
implementation.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from ..lanes import weighted_lane_sum
from . import _build

F32 = torch.float32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
H100_SMS = 132
SMEM_LIMIT = 232_448               # shared memory a block may use
SMEM_BYTES = SMEM_LIMIT - 32 * 4   # less the reduction scratch
SM_SMEM = 233_472                  # shared memory of one SM
SM_THREADS = 2048
MAX_THREADS = 512                  # csrc kMaxThreads
THREADS = 256                      # at most, where two blocks fit an SM
UNROLL = 4                         # loads a thread has in flight (csrc kUnroll)
TILE_BYTES = 16 * 1024             # input a block aims to own
WIDE_THREADS = 512                 # a block of the wide-row route (csrc kWideThreads)
WIDE_BLOCKS_PER_SM = 2             # its 64 registers a thread (ptxas, sm_90a)
VECTORS_PER_THREAD = 4             # loads per thread the thread count aims at
_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PLAN = [_CI] * 5                  # rows, slices, group_threads, vec, threads
_WIDE = [_CI] * 3                  # vec, threads, reread
_SIGNATURES = {
    "era_sharpen": [_VP, _VP, _CI, _CI, _CI, _CI, _CF, _CF, *_PLAN, _VP],
    "weighted_era_sharpen": [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CF, _CI,
                             *_PLAN, _VP],
    "era_sharpen_wide": [_VP, _VP, _CI, _CI, _CI, _CI, _CF, _CF, *_WIDE, _VP],
    "weighted_era_sharpen_wide": [_VP, _VP, _VP, _CI, _CI, _CI, _CI, _CF,
                                  _CI, *_WIDE, _VP],
}


@dataclass(frozen=True)
class LaunchPlan:
    rows: int                # R: consecutive output rows a block owns
    vec: int                 # V: values a load reads (16 bytes where aligned)
    slices: int              # S: contiguous slices of the client axis
    group_threads: int       # threads of one slice
    threads: int
    blocks: int
    smem_bytes: int          # the slices' partials, (S, R*C) floats
    inflight_bytes_per_sm: int   # loads issued before any is used, per SM
    wide: bool = False       # the wide-row route: one block a row, two passes
    reread: bool = False     # wide: pass 2 sums the inputs again (else reads out)

    def args(self):
        if self.wide:
            return (self.vec, self.threads, int(self.reread))
        return (self.rows, self.slices, self.group_threads, self.vec,
                self.threads)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def wide_plan(K: int, N: int, C: int, dtype=torch.float32,
              n_sms: int = H100_SMS) -> LaunchPlan:
    """The wide-row route's launch (rows of more than SMEM_BYTES / 4
    values): one block of WIDE_THREADS a row.  The load width is the widest
    of 16, 8, 4 and 2 bytes (one element at least) that divides N*C*elt, so
    every client's row sits at the same offset from a boundary and
    `wide_row_split` cuts them alike; pass 2 sums the inputs again where
    that reads no more than the 8 bytes a value that storing the sums in
    ``out`` and reading them back would move (K*elt <= 8)."""
    elt = 4 if dtype == torch.float32 else 2
    V = next(vb // elt for vb in (16, 8, 4, 2, elt)
             if vb >= elt and (N * C) % (vb // elt) == 0)
    U = max(1, 16 // V)                       # csrc: vectors loaded at once
    per_block = WIDE_THREADS * min(U, -(-C // (V * WIDE_THREADS))) * V * elt
    resident = min(-(-N // n_sms), WIDE_BLOCKS_PER_SM)
    return LaunchPlan(1, V, 1, WIDE_THREADS, WIDE_THREADS, N, 0,
                      per_block * resident, wide=True, reread=K * elt <= 8)


def wide_row_split(C: int, vec: int, row_elem_offset: int):
    """How the wide route cuts a row whose first value sits
    ``row_elem_offset`` elements past a ``vec``-element boundary: (head
    scalars, vectors, tail scalars), as csrc/era_sharpen.cu computes
    them."""
    mis = row_elem_offset % vec
    head = min(C, (vec - mis) % vec)
    nvec = (C - head) // vec
    return head, nvec, C - head - nvec * vec


def launch_plan(K: int, N: int, C: int, dtype=torch.float32,
                ptr_align: int = 256, n_sms: int = H100_SMS) -> LaunchPlan:
    """The kernel's launch for a contiguous (K, N, C) input whose pointer is
    a multiple of ``ptr_align`` bytes.  Rows that a block's shared memory
    cannot hold (C*4 > SMEM_BYTES) take the wide-row route (`wide_plan`);
    the rest:

    - The load width is the widest of 16, 8, 4 and 2 bytes (one element at
      least) that divides the pointer and N*C*elt, with which rows of a
      multiple of r0 = V/gcd(V, C) start every tile aligned.
    - R is the multiple of r0 nearest below TILE_BYTES of input per block,
      lowered while the grid would hold fewer than 1.5 blocks per SM.
    - The threads aim at VECTORS_PER_THREAD loads each, from 32 up to
      THREADS (MAX_THREADS where a row's aggregate leaves room for one
      block per SM only); where the tile has fewer vectors than that, the
      client axis splits into S slices, one group of threads each, as far
      as K and the shared memory for the partials allow."""
    if C * 4 > SMEM_BYTES:
        return wide_plan(K, N, C, dtype, n_sms)
    elt = 4 if dtype == torch.float32 else 2
    for vb in (16, 8, 4, 2, elt):    # one element always fits
        V = vb // elt
        r0 = V // math.gcd(V, C) if V else 0
        if (V and ptr_align % vb == 0 and (N * C) % V == 0
                and r0 * C * 4 <= SMEM_BYTES):
            break
    row_bytes = K * C * elt
    R = r0 * max(1, TILE_BYTES // (row_bytes * r0))
    R = min(R, _round_up(N, r0))
    while R > r0 and 2 * -(-N // R) < 3 * n_sms:
        R -= r0
    W = R * C
    G = W // V
    cap = MAX_THREADS if W * 4 > SM_SMEM // 2 else THREADS
    T = min(cap, max(32, _round_up(-(-K * G // VECTORS_PER_THREAD), 32)))
    if G >= T:
        S, Gt = 1, T
    else:
        S = max(1, min(K, T // G, SMEM_BYTES // (W * 4)))
        Gt, T = G, _round_up(S * G, 32)
    blocks = -(-N // R)
    smem = S * W * 4
    items = -(-G // Gt) * -(-K // S)       # (vector, client) loads a thread
    loads = S * min(Gt, G) * min(UNROLL, items)   # each of V values
    per_block = min(K * W, loads * V) * elt
    resident = min(-(-blocks // n_sms), SM_THREADS // T,
                   SM_SMEM // (smem + 1024 + 32 * 4))
    return LaunchPlan(R, V, S, Gt, T, blocks, smem, per_block * resident)


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
    """(K, N, C) x (K,) normalized weights -> (N, C) f32, summed lane after
    lane (`lanes.weighted_lane_sum`, as the rounds' other cross-client sums)
    so that a zero-weight lane changes no bit wherever it sits."""
    acc = weighted_lane_sum(weights, local_probs)
    if not sharpen:
        return acc
    return _softmax_rows(acc * (1.0 / temperature))


def check_probs(p: torch.Tensor, what: str):
    """(K, N, C) of a stack the kernels take, or ValueError: the checks
    that need no pointer (the fake implementations run them too)."""
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
    return K, N, C


def check_weights(weights: torch.Tensor, p: torch.Tensor) -> None:
    K = p.shape[0]
    if (weights.shape != (K,) or weights.dtype != F32
            or weights.device != p.device or not weights.is_contiguous()):
        raise ValueError(f"weighted_era_sharpen: weights must be a contiguous "
                         f"({K},) float32 tensor on {p.device}, got "
                         f"{tuple(weights.shape)} {weights.dtype} on "
                         f"{weights.device}")


def _plan(p: torch.Tensor, what: str):
    _build.require_cuda(p, what)
    K, N, C = check_probs(p, what)
    ptr = p.data_ptr()
    return K, N, C, launch_plan(K, N, C, p.dtype, ptr & -ptr,
                                _build.sm_count(p.device))


def launch_era_sharpen(local_probs: torch.Tensor,
                       temperature: float) -> torch.Tensor:
    """K1's launch on a CUDA tensor (the CUDA implementation of
    ``torch.ops.repro_torch.era_sharpen``); raises where it refuses."""
    K, N, C, plan = _plan(local_probs, "era_sharpen")
    out = torch.empty((N, C), dtype=F32, device=local_probs.device)
    lib = _lib()
    fn = lib.era_sharpen_wide if plan.wide else lib.era_sharpen
    err = fn(_build.ptr(local_probs), _build.ptr(out), K, N, C,
             _DTYPE_CODE[local_probs.dtype], 1.0 / K, 1.0 / temperature,
             *plan.args(), _build.stream_of(out))
    _build.check(lib, err, "era_sharpen")
    _build.LAUNCHES["era_sharpen"] += 1
    return out


def launch_weighted_era_sharpen(local_probs: torch.Tensor,
                                weights: torch.Tensor, temperature: float,
                                sharpen: bool) -> torch.Tensor:
    """K2's launch on CUDA tensors (the CUDA implementation of
    ``torch.ops.repro_torch.weighted_era_sharpen``)."""
    K, N, C, plan = _plan(local_probs, "weighted_era_sharpen")
    check_weights(weights, local_probs)
    out = torch.empty((N, C), dtype=F32, device=local_probs.device)
    lib = _lib()
    fn = (lib.weighted_era_sharpen_wide if plan.wide
          else lib.weighted_era_sharpen)
    err = fn(_build.ptr(local_probs), _build.ptr(weights), _build.ptr(out),
             K, N, C, _DTYPE_CODE[local_probs.dtype], 1.0 / temperature,
             int(sharpen), *plan.args(), _build.stream_of(out))
    _build.check(lib, err, "weighted_era_sharpen")
    _build.LAUNCHES["weighted_era_sharpen"] += 1
    return out


def era_sharpen(local_probs: torch.Tensor, temperature: float) -> torch.Tensor:
    """K1.  (K, N, C) f32 or bf16 -> (N, C) f32:
    ``softmax((sum_k p_k) * (1/K) / T)``, through the op
    ``torch.ops.repro_torch.era_sharpen`` (`kernels.library`)."""
    _build.require_device(local_probs, "era_sharpen")
    return torch.ops.repro_torch.era_sharpen(local_probs, temperature)


def weighted_era_sharpen(local_probs: torch.Tensor, weights: torch.Tensor,
                         temperature: float = 0.1,
                         sharpen: bool = True) -> torch.Tensor:
    """K2.  (K, N, C) f32 or bf16 x (K,) normalized f32 weights -> (N, C)
    f32: ``softmax(sum_k w_k p_k / T)``, or the weighted mean itself with
    ``sharpen=False``.  A zero-weight client changes no bit.  Through the
    op ``torch.ops.repro_torch.weighted_era_sharpen``."""
    _build.require_device(local_probs, "weighted_era_sharpen")
    return torch.ops.repro_torch.weighted_era_sharpen(
        local_probs, weights, temperature, sharpen)


from . import library  # noqa: E402,F401  (registers the ops)
