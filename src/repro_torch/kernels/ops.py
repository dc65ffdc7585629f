"""The kernels as the rest of the port calls them (mirrors
``repro/kernels/ops.py``).  The teacher-building ops are not differentiated;
the distillation loss is a `torch.autograd.Function` whose forward is K3 and
whose backward is K4; the SSD chunk block (K5) serves inference only, as in
the reference (no backward).  On CPU tensors every op runs its plain
version.
"""
from __future__ import annotations

import torch

from .distill_loss import distill_loss_bwd, distill_loss_fwd
from . import era_sharpen as _era
from . import ssd_chunk as _ssd

F32 = torch.float32


def era_sharpen(local_probs: torch.Tensor,
                temperature: float = 0.1) -> torch.Tensor:
    """(K, N, C) -> (N, C).  Teacher construction, not differentiated."""
    return _era.era_sharpen(local_probs.detach(), temperature)


def weighted_era_sharpen(local_probs: torch.Tensor, weights: torch.Tensor,
                         temperature: float = 0.1) -> torch.Tensor:
    """(K, N, C) x (K,) normalized weights -> (N, C): weighted mean and
    sharpen in one pass.  Zero-weight clients contribute exactly nothing."""
    return _era.weighted_era_sharpen(local_probs.detach(),
                                     weights.detach().to(F32).contiguous(),
                                     temperature)


def weighted_mean(local_probs: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """(K, N, C) x (K,) normalized weights -> (N, C) weighted mean (the
    ``weighted_sa`` route: the same kernel with the softmax skipped)."""
    return _era.weighted_era_sharpen(local_probs.detach(),
                                     weights.detach().to(F32).contiguous(),
                                     sharpen=False)


class distill_loss_2d(torch.autograd.Function):
    """Mean over rows of CE(t || softmax(z)) for z, t: (N, V).  The gradient
    flows to z only, as in the reference's ``custom_vjp``."""

    @staticmethod
    def forward(ctx, z, t):
        losses, logz = distill_loss_fwd(z, t)
        tmass = t.sum(dim=-1, dtype=F32)   # bf16 t is not copied to f32
        ctx.save_for_backward(z, t, logz, tmass)
        return losses.mean()

    @staticmethod
    def backward(ctx, g):
        z, t, logz, tmass = ctx.saved_tensors
        # a (1,) device tensor: the kernel reads the scale itself, so the
        # backward never waits for the device to hand g to the host
        gscale = (g.to(F32) / z.shape[0]).reshape(1).contiguous()
        return distill_loss_bwd(z, t, logz, tmass, gscale), None


def distill_loss(student_logits: torch.Tensor, teacher_probs: torch.Tensor,
                 mask=None) -> torch.Tensor:
    """Arbitrary leading dims.  With a mask the kernel does not apply, and
    the loss is the reference's masked soft-target cross-entropy.  K3/K4
    take z and t of one dtype; where they differ (f32 logits against the
    bf16 teacher) both are widened to f32, which is exact, as the
    reference's kernel upcasts both (z is never rounded)."""
    if mask is not None:
        from ..core.losses import softmax_xent
        return softmax_xent(student_logits, teacher_probs, mask)
    if teacher_probs.dtype != student_logits.dtype:
        student_logits = student_logits.to(F32)
        teacher_probs = teacher_probs.to(F32)
    V = student_logits.shape[-1]
    z = student_logits.reshape(-1, V).contiguous()
    t = teacher_probs.reshape(-1, V).contiguous()
    return distill_loss_2d.apply(z, t)


# -------------------------------------------------------------- ssd chunk ----
def ssd_chunk(xr, dtr, dAr, Br, Cr, hpg: int) -> torch.Tensor:
    """The within-chunk blocks of ``models.ssm.ssd_chunked`` (the
    reference's ``_chunk_local``): xr: (B, nc, Q, H, P), dtr/dAr:
    (B, nc, Q, H), Br/Cr: (B, nc, Q, G, N) -> (B, nc, Q, H, P) fp32.
    ``hpg`` (heads per group) must agree with the shapes (H // G)."""
    B, nc, Q, H, P = xr.shape
    G, N = Br.shape[3], Br.shape[4]
    if H != hpg * G:
        raise ValueError(f"ssd_chunk: hpg={hpg} with G={G} groups does not "
                         f"give H={H} heads")
    y = _ssd.ssd_chunk(xr.reshape(B * nc, Q, H, P).contiguous(),
                       dtr.reshape(B * nc, Q, H).contiguous(),
                       dAr.reshape(B * nc, Q, H).contiguous(),
                       Br.reshape(B * nc, Q, G, N).contiguous(),
                       Cr.reshape(B * nc, Q, G, N).contiguous())
    return y.reshape(B, nc, Q, H, P)
