"""Synthetic image data (mirrors the image part of
``repro/data/synthetic.py``): the MNIST stand-in ``digits``, smooth
per-class templates with a random shift and pixel noise.

The class templates are numpy-exact copies of the reference's (the same
``np.random.default_rng`` stream and arithmetic); labels, shifts and noise
come from a ``torch.Generator`` on the data's device, so they differ from
the reference's ``jax.random`` draws."""
from __future__ import annotations

import numpy as np
import torch


def _templates(seed: int, n_classes: int, hw: int, grid: int = 4) -> np.ndarray:
    """Smooth class templates: bilinear-upsampled random coarse grids."""
    rng = np.random.default_rng(seed)
    coarse = rng.normal(size=(n_classes, grid, grid)).astype(np.float32)
    # bilinear upsample to (hw, hw)
    xs = np.linspace(0, grid - 1, hw)
    x0 = np.clip(np.floor(xs).astype(int), 0, grid - 2)
    fx = (xs - x0).astype(np.float32)
    rows = (coarse[:, x0] * (1 - fx[None, :, None])
            + coarse[:, x0 + 1] * fx[None, :, None])          # (C, hw, grid)
    cols = (rows[:, :, x0] * (1 - fx[None, None, :])
            + rows[:, :, x0 + 1] * fx[None, None, :])         # (C, hw, hw)
    t = cols - cols.mean(axis=(1, 2), keepdims=True)
    return t / (t.std(axis=(1, 2), keepdims=True) + 1e-6)


def make_digits(gen: torch.Generator, n: int, n_classes: int = 10,
                hw: int = 16, template_seed: int = 1234, noise: float = 0.35):
    """Returns x: (n, hw, hw, 1) float32 and y: (n,) int64 on the
    generator's device.  Each image is its class template rolled by a shift
    in [-2, 2] along both axes, plus ``noise`` times standard normal
    noise."""
    dev = gen.device
    templates = torch.as_tensor(_templates(template_seed, n_classes, hw),
                                device=dev)
    y = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    shifts = torch.randint(-2, 3, (n, 2), generator=gen, device=dev)
    ar = torch.arange(hw, device=dev)
    # roll by s: out[i] = img[(i - s) % hw], along rows then columns
    ri = (ar[None, :] - shifts[:, :1]) % hw                   # (n, hw)
    ci = (ar[None, :] - shifts[:, 1:]) % hw
    imgs = templates[y[:, None, None], ri[:, :, None], ci[:, None, :]]
    imgs = imgs + noise * torch.randn(imgs.shape, generator=gen, device=dev)
    return imgs[..., None].to(torch.float32), y
