"""Attack models of paper Section 4.1 "(2-7) Attack settings" (mirrors
``repro/core/attacks.py``).

  * noisy labels    - each client relabels C source classes to C false
                      classes (every client attacks: the worst case);
  * noisy open data - N semantically foreign samples join the open set;
  * model poisoning - the replacement attack on FedAvg (Eqs. 17-19), and
                      its DS-FL form (a malicious client uploads the
                      probabilities of a backdoored model and never
                      trains it).

Draws come from a ``torch.Generator``, so they differ from the
reference's ``jax.random`` draws; the rest is its arithmetic.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def noisy_label_map(gen: torch.Generator, n_classes: int, C: int
                    ) -> torch.Tensor:
    """One client's class remap (n_classes,): C distinct source classes
    are sent to C distinct false classes; the others map to themselves."""
    src = torch.randperm(n_classes, generator=gen, device=gen.device)[:C]
    dst = torch.randperm(n_classes, generator=gen, device=gen.device)[:C]
    table = torch.arange(n_classes, device=gen.device)
    table[src] = dst
    return table


def apply_noisy_labels(gen: torch.Generator, labels: torch.Tensor,
                       n_classes: int, C: int) -> torch.Tensor:
    """labels: (K, I) -> the noised labels; each client gets its own
    remap."""
    maps = torch.stack([noisy_label_map(gen, n_classes, C)
                        for _ in range(labels.shape[0])]).to(labels.device)
    return torch.gather(maps, 1, labels.long())


def mix_noisy_open(open_x: torch.Tensor, noise_x: torch.Tensor,
                   gen: torch.Generator) -> torch.Tensor:
    """The open set with the foreign samples appended, shuffled (the
    noisy-open attack)."""
    allx = torch.cat([open_x, noise_x], dim=0)
    return allx[torch.randperm(allx.shape[0], generator=gen,
                               device=gen.device).to(allx.device)]


# ----------------------------- model poisoning -------------------------------
def poison_fl_upload(w_backdoor: dict, w_global: dict, K: int) -> dict:
    """Eq. 19: the upload that replaces the FedAvg global model with
    w_backdoor after averaging, w_M = K w_x - (K - 1) w_g, in float32."""
    return {k: (K * wx.to(F32) - (K - 1) * w_global[k].to(F32)).to(wx.dtype)
            for k, wx in w_backdoor.items()}


def make_logit_poison(apply_fn, w_backdoor, s_backdoor,
                      malicious_idx: int = 0):
    """The DS-FL form of the attack, as a ``DSFLAlgorithm(corrupt=...)``
    hook.  As in the reference, the hook returns the uploads unchanged:
    `logit_poison_probs` and `replace_client_probs` are the parts a caller
    composes into a working one."""

    def corrupt(probs, xo=None, gen=None):
        return probs

    return corrupt


def logit_poison_probs(apply_fn, w_x, s_x, xo) -> torch.Tensor:
    """The backdoored model's probabilities on the open batch."""
    with torch.no_grad():
        logits, _ = apply_fn(w_x, s_x, xo, False)
    return torch.softmax(logits.to(F32), dim=-1)


def replace_client_probs(probs: torch.Tensor, malicious_probs: torch.Tensor,
                         idx: int = 0) -> torch.Tensor:
    """probs (K, n, C) with client ``idx``'s row replaced."""
    out = probs.clone()
    out[idx] = malicious_probs
    return out
