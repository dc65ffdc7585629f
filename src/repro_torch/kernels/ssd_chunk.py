"""K5: Mamba2's within-chunk ("diagonal") SSD block, with its plain
PyTorch version.

The CUDA kernel is in ``csrc/ssd_chunk.cu`` (one block per chunk, head,
64-row query tile and 64-column head-dim tile, walking the key tiles up to
the diagonal in fp32; the note there gives its bound).  A wrapper given a
CPU tensor computes the plain version; given a CUDA tensor it launches the
kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

F32 = torch.float32
SMEM_LIMIT = 232_448               # bytes of shared memory a block may use
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssd_chunk": [_VP] * 6 + [_CI] * 6 + [_VP],
    "ssd_chunk_smem_bytes": [_CI, _CI],
}


def _lib() -> ctypes.CDLL:
    lib = _build.library("ssd_chunk", _SIGNATURES)
    lib.ssd_chunk_smem_bytes.restype = ctypes.c_longlong
    return lib


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


def _check(x, dt, dA, Bm, Cm):
    _build.require_cuda(x, "ssd_chunk")
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in
                                       (x, dt, dA, Bm, Cm)):
        raise RuntimeError("ssd_chunk: the kernel has no backward (it "
                           "serves inference, as in the reference); run it "
                           "under torch.no_grad() or take the plain route")
    return M, Q, H, P, G, N


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, dA: torch.Tensor,
              Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """K5.  x: (M, Q, H, P); dt/dA: (M, Q, H); Bm/Cm: (M, Q, G, N), all
    contiguous f32 -> y (M, Q, H, P) f32; head h reads group h // (H/G)."""
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, dA, Bm, Cm)
    M, Q, H, P, G, N = _check(x, dt, dA, Bm, Cm)
    lib = _lib()
    smem = lib.ssd_chunk_smem_bytes(Q, N)
    if smem > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk: chunk length Q={Q} and state size N={N} "
                         f"need {smem} bytes of shared memory per block, "
                         f"above the card's {SMEM_LIMIT}")
    n_blocks = M * H * -(-Q // 64) * -(-P // 64)
    if n_blocks >= 2 ** 31:
        raise ValueError(f"ssd_chunk: {n_blocks} blocks exceed the grid limit")
    y = torch.empty((M, Q, H, P), dtype=F32, device=x.device)
    err = lib.ssd_chunk(_build.ptr(x), _build.ptr(dt), _build.ptr(dA),
                        _build.ptr(Bm), _build.ptr(Cm), _build.ptr(y),
                        M, Q, H, P, G, N, _build.stream_of(y))
    _build.check(lib, err, "ssd_chunk")
    _build.LAUNCHES["ssd_chunk"] += 1
    return y
