"""Plain PyTorch oracles for the kernels (mirrors ``repro/kernels/ref.py``):
the definitions the kernels and their plain versions are held to."""
from __future__ import annotations

import torch

F32 = torch.float32


def era_sharpen_ref(local_probs: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """(K, N, C) client probs -> (N, C) sharpened global logit (Eq. 13)."""
    mean = local_probs.to(F32).mean(dim=0)
    return torch.softmax(mean / temperature, dim=-1)


def weighted_era_sharpen_ref(local_probs: torch.Tensor, weights: torch.Tensor,
                             temperature: float = 0.1,
                             sharpen: bool = True) -> torch.Tensor:
    """(K, N, C) x (K,) normalized weights -> (N, C) weighted mean, sharpened
    unless ``sharpen=False``."""
    mean = torch.einsum("k,knc->nc", weights.to(F32), local_probs.to(F32))
    if not sharpen:
        return mean
    return torch.softmax(mean / temperature, dim=-1)


def distill_loss_ref(student_logits: torch.Tensor,
                     teacher_probs: torch.Tensor) -> torch.Tensor:
    """(N, V) -> per-row soft-target CE (N,) in fp32."""
    x = student_logits.to(F32)
    ls = torch.log_softmax(x, dim=-1)
    return -(teacher_probs.to(F32) * ls).sum(dim=-1)


def distill_loss_grad_ref(student_logits, teacher_probs, g):
    """d(mean loss)/d logits given the upstream scalar cotangent g."""
    x = student_logits.to(F32)
    p = torch.softmax(x, dim=-1)
    t = teacher_probs.to(F32)
    tmass = t.sum(dim=-1, keepdim=True)
    return (g / x.shape[0]) * (p * tmass - t)

