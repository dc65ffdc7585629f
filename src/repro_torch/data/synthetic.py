"""Synthetic data (mirrors ``repro/data/synthetic.py``; the real datasets
are replaced by procedural stand-ins):

* ``make_digits``        - the MNIST stand-in: smooth per-class templates
                           with a random shift and pixel noise.
* ``make_fashion_noise`` - a foreign image family (another template seed,
                           a sharper texture): the noisy open set's and
                           the backdoor's data.
* ``make_bow``           - the Reuters stand-in: class-conditional sparse
                           binary bags of words.
* ``make_token_lm``      - the token LM corpus (the IMDb stand-in, with two
                           domains as the label).

The class templates and the domain unigrams are numpy-exact copies of the
reference's (the same ``np.random.default_rng`` stream and arithmetic);
every other draw comes from a ``torch.Generator`` on the data's device, so
it differs from the reference's ``jax.random`` draws."""
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


def make_fashion_noise(gen: torch.Generator, n: int, n_classes: int = 10,
                       hw: int = 16):
    """Foreign images: ``make_digits`` of the template seed 777 at noise
    0.5, plus 0.3 times the sign of a normal texture."""
    x, y = make_digits(gen, n, n_classes, hw, template_seed=777, noise=0.5)
    texture = torch.randn(x.shape, generator=gen, device=gen.device) * 0.4
    return (x + torch.sign(texture) * 0.3).to(torch.float32), y


# ------------------------------------------------------------------- bow -----
def _log_gamma_draws(gen: torch.Generator, alpha: float, shape) -> torch.Tensor:
    """log of Gamma(alpha, 1) draws for alpha < 1 (Marsaglia and Tsang's
    method at alpha + 1, with the boost ``U ** (1 / alpha)`` taken in
    logs so that draws far below the smallest float32 keep their order)."""
    dev = gen.device
    d = alpha + 1.0 - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    out = torch.empty(shape, device=dev)
    todo = torch.ones(shape, dtype=torch.bool, device=dev)
    while bool(todo.any()):
        x = torch.randn(shape, generator=gen, device=dev)
        u = torch.rand(shape, generator=gen, device=dev)
        v = (1.0 + c * x) ** 3
        ok = todo & (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                               + d * torch.log(v.clamp_min(1e-30)))
        out = torch.where(ok, torch.log(d * v.clamp_min(1e-30)), out)
        todo &= ~ok
    u = torch.rand(shape, generator=gen, device=dev)
    return out + torch.log(u) / alpha


def make_bow(gen: torch.Generator, n: int, n_classes: int = 20,
             vocab: int = 1000, words_per_doc: int = 40):
    """Class-conditional sparse binary bags of words: a Dirichlet(0.05)
    topic over the vocabulary per class; each document sets the words of
    ``words_per_doc`` draws (with replacement) from its class's topic.
    Returns x: (n, vocab) float32 and y: (n,) int64 on the generator's
    device."""
    dev = gen.device
    topic = torch.softmax(_log_gamma_draws(gen, 0.05, (n_classes, vocab)),
                          dim=-1)
    y = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
    words = torch.multinomial(topic[y], words_per_doc, replacement=True,
                              generator=gen)
    docs = torch.zeros((n, vocab), device=dev).scatter_(1, words, 1.0)
    return docs, y


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
