"""K5: Mamba2's within-chunk ("diagonal") SSD block, with its plain
PyTorch version.

The CUDA kernel is in ``csrc/ssd_chunk.cu``: one block per chunk, group,
64-row query tile and slice of at most 16 of the group's heads; the block
forms the scores C·Bᵀ of its query rows once, keeps them in shared memory
and walks each head of the slice over its key tiles, with both products on
the tensor cores in 3xTF32 (fp32 accuracy).  The note there gives its bound.
`launch_plan` picks the slice size and checks the shared memory.  The
wrapper calls the op of `kernels.library`: a CPU tensor takes the plain
version, a CUDA tensor the kernel (or an exception), a fake tensor the
fake implementation.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build

F32 = torch.float32
SMEM_LIMIT = 232_448               # bytes of shared memory a block may use
H100_SMS = 132
MAX_HEADS = 16                      # heads per block at most (csrc kMaxHeads)
TILE = 64                          # query rows per block, key rows per tile
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_chunk": [_VP] * 6 + [_CI] * 7 + [_VP],
    "ssd_chunk_smem_bytes": [_CI, _CI, _CI],
}


def _lib() -> ctypes.CDLL:
    lib = _build.library("ssd_chunk", _SIGNATURES)
    lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
    return lib


def smem_bytes(Q: int, N: int, hs: int) -> int:
    """Shared memory of one block, as ``csrc/ssd_chunk.cu`` lays it out: the
    staging area (the C tile and two B tiles, N padded to 8k + 4 floats, or
    two x tiles of 64 x 72 and the key halves' sums of y, 4 x 32 x 32), the
    score tiles (64 x 68 each), and the cumsum and dt of hs heads."""
    n_qt = -(-Q // TILE)
    stage = max(3 * TILE * (-(-N // 8) * 8 + 4),
                2 * TILE * (TILE + 8) + 4 * 32 * 32)
    return 4 * (stage + n_qt * TILE * (TILE + 4) + 2 * hs * n_qt * TILE)


@dataclass(frozen=True)
class LaunchPlan:
    heads_per_block: int   # hs: heads of a group that share one block's scores
    slices: int            # blocks per (chunk, group, query tile)
    query_tiles: int
    blocks: int
    smem_bytes: int


def launch_plan(M: int, Q: int, H: int, G: int, N: int,
                n_sms: int = H100_SMS) -> LaunchPlan:
    """hs = min(H/G, 8), halved while the grid would hold fewer blocks than
    the card has SMs, then lowered while a block's shared memory would not
    fit.  Raises if even one head per block does not fit."""
    hpg, n_qt = H // G, -(-Q // TILE)
    hs = min(hpg, MAX_HEADS)
    while hs > 1 and M * G * n_qt * -(-hpg // hs) < n_sms:
        hs //= 2
    while hs > 1 and smem_bytes(Q, N, hs) > SMEM_LIMIT:
        hs -= 1
    smem = smem_bytes(Q, N, hs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk: chunk length Q={Q} and state size N={N} "
                         f"need {smem} bytes of shared memory per block, "
                         f"above the card's {SMEM_LIMIT}")
    slices = -(-hpg // hs)
    return LaunchPlan(hs, slices, n_qt, M * G * n_qt * slices, smem)


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x: (M, Q, H, P); dt/dA: (M, Q, H); Bm/Cm: (M, Q, G, N) -> y
    (M, Q, H, P) f32: the kernel's arithmetic in plain PyTorch.  The
    scores are formed once per group and shared by its H/G heads; the decay
    is exp of -inf above the diagonal, an exact 0, as the kernel skips it."""
    M, Q, H, P = x.shape
    hpg = H // Bm.shape[2]
    cum = torch.cumsum(dA.to(F32), dim=1).transpose(1, 2)      # (M, H, Q)
    T = cum[:, :, :, None] - cum[:, :, None, :]                # (M, H, Q, Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(T.masked_fill(~causal, float("-inf")))
    scores = torch.einsum("mqgn,mkgn->mgqk", Cm.to(F32), Bm.to(F32))
    scores = torch.repeat_interleave(scores, hpg, dim=1)       # (M, H, Q, Q)
    W = scores * L * dt.to(F32).transpose(1, 2)[:, :, None, :]
    return torch.einsum("mhqk,mkhp->mqhp", W, x.to(F32))


def check(x, dt, dA, Bm, Cm):
    """(M, Q, H, P, G, N) of inputs the kernel takes, or an exception: the
    checks that need no pointer (the fake implementation runs them too)."""
    if x.ndim != 4 or Bm.ndim != 4:
        raise ValueError(f"ssd_chunk: expected x (M, Q, H, P) and B, C "
                         f"(M, Q, G, N), got {tuple(x.shape)} and "
                         f"{tuple(Bm.shape)}")
    M, Q, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    want = {"x": (x, (M, Q, H, P)), "dt": (dt, (M, Q, H)),
            "dA": (dA, (M, Q, H)), "B": (Bm, (M, Q, G, N)),
            "C": (Cm, (M, Q, G, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"ssd_chunk: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != F32:
            raise ValueError(f"ssd_chunk: {name} dtype {t.dtype} not "
                             f"supported (float32)")
        if t.device != x.device:
            raise ValueError(f"ssd_chunk: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk: {name} must be contiguous")
    if min(M, Q, H, P, G, N) == 0:
        raise ValueError(f"ssd_chunk: empty shape x {tuple(x.shape)}, "
                         f"B {tuple(Bm.shape)}")
    if H % G:
        raise ValueError(f"ssd_chunk: H={H} heads do not split into G={G} "
                         f"groups")
    return M, Q, H, P, G, N


def launch_ssd_chunk(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
                     Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """K5's launch on CUDA tensors (the CUDA implementation of
    ``torch.ops.repro_torch.ssd_chunk``)."""
    _build.require_cuda(x, "ssd_chunk")
    M, Q, H, P, G, N = check(x, dt, dA, Bm, Cm)
    plan = launch_plan(M, Q, H, G, N, _build.sm_count(x.device))
    if plan.blocks >= 2 ** 31:
        raise ValueError(f"ssd_chunk: {plan.blocks} blocks exceed the grid "
                         f"limit")
    lib = _lib()
    y = torch.empty((M, Q, H, P), dtype=F32, device=x.device)
    err = lib.ssd_chunk(_build.ptr(x), _build.ptr(dt), _build.ptr(dA),
                        _build.ptr(Bm), _build.ptr(Cm), _build.ptr(y),
                        M, Q, H, P, G, N, plan.heads_per_block,
                        _build.stream_of(y))
    _build.check(lib, err, "ssd_chunk")
    _build.LAUNCHES["ssd_chunk"] += 1
    return y


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """K5.  x: (M, Q, H, P); dt/dA: (M, Q, H); Bm/Cm: (M, Q, G, N), all
    contiguous f32 -> y (M, Q, H, P) f32; head h reads group h // (H/G).
    Through the op ``torch.ops.repro_torch.ssd_chunk``, which has no
    backward: on CUDA tensors an input that needs a gradient is refused;
    on CPU tensors it takes the (differentiable) plain version itself."""
    _build.require_device(x, "ssd_chunk")
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, dt, dA, Bm, Cm)):
        if x.device.type == "cpu":
            return ssd_chunk_plain(x, dt, dA, Bm, Cm)
        raise RuntimeError("ssd_chunk: the kernel has no backward (it "
                           "serves inference, as in the reference); run it "
                           "under torch.no_grad() or take the plain route")
    return torch.ops.repro_torch.ssd_chunk(x, dt, dA, Bm, Cm)


from . import library  # noqa: E402,F401  (registers the ops)
