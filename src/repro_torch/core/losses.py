"""Loss functions (fp32 statistics).  The distillation loss has a fused
kernel path (K3/K4, `repro_torch.kernels.ops.distill_loss`) selected by
``use_kernel``.

``pinned_sum``/``pinned_mean`` keep the reference's names.  There they pin
XLA's reduction order across programs; PyTorch runs eagerly, so here they
are plain fp32 sums.  Sums over the client axis are `lanes.lane_sum`."""
from __future__ import annotations

import torch

F32 = torch.float32


def pinned_sum(v: torch.Tensor) -> torch.Tensor:
    """fp32 sum over all axes."""
    return v.to(F32).sum()


def pinned_mean(ce: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean (or mask-weighted mean) of a per-sample loss tensor."""
    if mask is not None:
        return pinned_sum(ce * mask) / torch.clamp(pinned_sum(mask), min=1.0)
    return pinned_sum(ce) / ce.numel()


def log_softmax(logits: torch.Tensor) -> torch.Tensor:
    x = logits.to(F32)
    s = x - x.amax(dim=-1, keepdim=True)
    return s - torch.log(torch.exp(s).sum(dim=-1, keepdim=True))


def softmax_xent(logits, labels_onehot, mask=None):
    """Cross-entropy vs hard one-hot or soft targets. logits: (..., C)."""
    ce = -(labels_onehot.to(F32) * log_softmax(logits)).sum(dim=-1)
    return pinned_mean(ce, mask)


def xent_int_labels(logits, labels, mask=None):
    """CE with integer labels, without materializing one-hots."""
    ls = log_softmax(logits)
    ce = -torch.gather(ls, -1, labels[..., None].long())[..., 0]
    return pinned_mean(ce, mask)


def distill_xent(student_logits, teacher_probs, mask=None, use_kernel=False):
    """KD loss: CE(teacher_probs || softmax(student_logits)), the DS-FL
    "6. Distillation" objective (Eq. 10) with the global logit as soft
    target.  ``use_kernel=True`` computes it with K3 and its gradient with
    K4 (on CPU tensors, their plain versions)."""
    if use_kernel:
        from ..kernels import ops as kops
        return kops.distill_loss(student_logits, teacher_probs, mask)
    return softmax_xent(student_logits, teacher_probs, mask)


def topk_distill_xent(student_logits, topk_p, topk_i, mask=None):
    """KD against a sparsified teacher: sum over the k kept entries only.
    topk_p: (..., k) renormalized probs; topk_i: (..., k) vocab indices."""
    sel = torch.gather(log_softmax(student_logits), -1, topk_i.long())
    ce = -(topk_p.to(F32) * sel).sum(dim=-1)
    return pinned_mean(ce, mask)


def entropy(probs, dim=-1):
    p = probs.to(F32)
    return -(p * torch.log(torch.clamp(p, 1e-12, 1.0))).sum(dim=dim)


def accuracy(logits, labels):
    return (logits.argmax(dim=-1) == labels).to(F32).mean()
