"""Device resolution for the port's entry points.

Entry points run on the card by default (``device="cuda"``).  Asking for a
CUDA device where there is none raises; nothing falls back to the CPU.  The
CPU is used only when the caller asks for it (``device="cpu"``), and then
every kernel wrapper computes its plain version."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but torch sees no CUDA "
            f"device; pass device='cpu' to run on the CPU")
    return d


def generator(device, seed: int) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
