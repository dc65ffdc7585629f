"""Synthetic data (mirrors the image and token parts of
``repro/data/synthetic.py``): the MNIST stand-in ``digits``, smooth
per-class templates with a random shift and pixel noise, and the token LM
corpus ``make_token_lm``.

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


# --------------------------------------------------------------- token LM ----
def _domain_probs(vocab: int, n_domains: int) -> np.ndarray:
    """(D, V) float32 unigram of each domain: a Zipf unigram with the
    domain's block of the vocabulary weighted 20x, normalized (a
    numpy-exact copy of the reference's)."""
    zipf = 1.0 / (np.arange(1, vocab + 1) ** 1.1)
    zipf /= zipf.sum()
    doms = []
    for d in range(n_domains):
        lo = (vocab * d) // n_domains
        hi = (vocab * (d + 1)) // n_domains
        p = zipf.copy()
        p[lo:hi] *= 20.0
        doms.append(p / p.sum())
    return np.stack(doms).astype(np.float32)


def make_token_lm(gen: torch.Generator, n_seqs: int, seq_len: int,
                  vocab: int, n_domains: int = 4, order_mix: float = 0.7):
    """Synthetic LM corpus: each sequence follows its domain's first-order
    chain, ``order_mix * p_domain + (1 - order_mix) * onehot((prev * 7 +
    13) % vocab)``; the domain id doubles as the non-IID partition key.
    Returns tokens (n_seqs, seq_len) int64 and domains (n_seqs,) int64 on
    the generator's device.

    The reference samples the mixture at each step; here each token is a
    draw from the domain's unigram with probability ``order_mix`` and the
    successor of the previous token otherwise, which is the same
    distribution (the draws differ, as ``torch.Generator`` is not
    ``jax.random``).  The first token is a unigram draw."""
    dev = gen.device
    domains = torch.randint(0, n_domains, (n_seqs,), generator=gen,
                            device=dev)
    dom_p = torch.as_tensor(_domain_probs(vocab, n_domains), device=dev)
    draws = torch.multinomial(dom_p[domains], seq_len, replacement=True,
                              generator=gen)                    # (n, S)
    from_unigram = torch.rand((n_seqs, seq_len), generator=gen,
                              device=dev) < order_mix
    toks = torch.empty_like(draws)
    toks[:, 0] = draws[:, 0]
    for t in range(1, seq_len):
        toks[:, t] = torch.where(from_unigram[:, t], draws[:, t],
                                 (toks[:, t - 1] * 7 + 13) % vocab)
    return toks, domains
