"""The paper's evaluation models (Section 4.1) in PyTorch, functional, over
flat dicts of tensors (mirrors ``repro/models/smallnets.py``).

  * MNIST CNN: 582,410 values at ``image_hw=28, widths=(32, 64), fc=512``,
    counting the BatchNorm running statistics as Keras does; 582,218 of them
    are trainable.
  * tiny MLP: the beyond-paper micro model of the simulation smoke runs.

``init(gen) -> (params, state)`` draws from a ``torch.Generator`` on the
model's device; ``apply(params, state, x, train) -> (logits, new_state)``.
The layouts are the reference's at every public name, so weights carry
across leaf by leaf: images are NHWC, convolution weights HWIO, dense
weights (in, out), and parameters are named ``c1/w``, ``bn1/scale`` and so
on.  ``apply`` permutes to NCHW/OIHW inside for ``F.conv2d``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F

from ..device import resolve_device

F32 = torch.float32


def _dense(p, name, gen, n_in, n_out, device):
    p[f"{name}/w"] = torch.randn((n_in, n_out), generator=gen, dtype=F32,
                                 device=device) * (2.0 / n_in) ** 0.5
    p[f"{name}/b"] = torch.zeros((n_out,), dtype=F32, device=device)


def _conv(p, name, gen, kh, kw, cin, cout, device):
    p[f"{name}/w"] = torch.randn((kh, kw, cin, cout), generator=gen,
                                 dtype=F32, device=device) \
        * (2.0 / (kh * kw * cin)) ** 0.5
    p[f"{name}/b"] = torch.zeros((cout,), dtype=F32, device=device)


def _bn(p, s, name, c, device):
    p[f"{name}/scale"] = torch.ones((c,), dtype=F32, device=device)
    p[f"{name}/bias"] = torch.zeros((c,), dtype=F32, device=device)
    s[f"{name}/mean"] = torch.zeros((c,), dtype=F32, device=device)
    s[f"{name}/var"] = torch.ones((c,), dtype=F32, device=device)


def conv2d(p, name, x):
    """VALID convolution of an NCHW activation with an HWIO weight."""
    w = p[f"{name}/w"].permute(3, 2, 0, 1)
    return F.conv2d(x, w) + p[f"{name}/b"][:, None, None]


def batchnorm(p, s, name, x, train: bool, momentum=0.9, eps=1e-5):
    """BatchNorm over every axis but channels (axis 1 of NCHW), written out:
    the running statistics take the *biased* batch variance, as
    ``momentum * old + (1 - momentum) * new``."""
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if train:
        axes = (0,) + tuple(range(2, x.ndim))
        m = x.mean(dim=axes)
        v = x.var(dim=axes, correction=0)
        ns = {f"{name}/mean": momentum * s[f"{name}/mean"] + (1 - momentum) * m,
              f"{name}/var": momentum * s[f"{name}/var"] + (1 - momentum) * v}
    else:
        m, v = s[f"{name}/mean"], s[f"{name}/var"]
        ns = {f"{name}/mean": m, f"{name}/var": v}
    y = (x - m.reshape(shape)) * torch.rsqrt(v.reshape(shape) + eps) \
        * p[f"{name}/scale"].reshape(shape) + p[f"{name}/bias"].reshape(shape)
    return y, ns


# -------------------------------------------------------------- MNIST CNN ----
def init_mnist_cnn(gen: torch.Generator, n_classes=10, image_hw=28,
                   widths=(32, 64), fc=512, device="cuda"):
    device = resolve_device(device)
    p, s = {}, {}
    _conv(p, "c1", gen, 5, 5, 1, widths[0], device)
    _bn(p, s, "bn1", widths[0], device)
    _conv(p, "c2", gen, 5, 5, widths[0], widths[1], device)
    _bn(p, s, "bn2", widths[1], device)
    hw = ((image_hw - 4) // 2 - 4) // 2      # two valid 5x5 convs + two pools
    _dense(p, "d1", gen, hw * hw * widths[1], fc, device)
    _dense(p, "d2", gen, fc, n_classes, device)
    return p, s


def apply_mnist_cnn(p, s, x, train: bool):
    ns = {}
    h = conv2d(p, "c1", x.permute(0, 3, 1, 2))
    h, bn1 = batchnorm(p, s, "bn1", h, train)
    h = F.max_pool2d(torch.relu(h), 2, 2)
    h = conv2d(p, "c2", h)
    h, bn2 = batchnorm(p, s, "bn2", h, train)
    h = F.max_pool2d(torch.relu(h), 2, 2)
    ns.update(bn1)
    ns.update(bn2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten order
    h = torch.relu(h @ p["d1/w"] + p["d1/b"])
    return h @ p["d2/w"] + p["d2/b"], ns


# ---------------------------------------------------------------- tiny MLP ---
def init_tiny_mlp(gen: torch.Generator, n_classes=10, image_hw=16, hidden=32,
                  device="cuda"):
    device = resolve_device(device)
    p = {}
    _dense(p, "d1", gen, image_hw * image_hw, hidden, device)
    _dense(p, "d2", gen, hidden, n_classes, device)
    return p, {}


def apply_tiny_mlp(p, s, x, train: bool):
    h = x.reshape(x.shape[0], -1)
    h = torch.relu(h @ p["d1/w"] + p["d1/b"])
    return h @ p["d2/w"] + p["d2/b"], s


def param_count(*trees) -> int:
    return sum(int(v.numel()) for t in trees for v in t.values())


# ---------------------------------------------------- registry & factories ---
@dataclass(frozen=True)
class SmallNet:
    name: str
    init: Callable
    apply: Callable
    input_kind: str          # image | tokens | bow
    n_classes: int


_NOT_PORTED = ("fmnist_cnn", "imdb_lstm", "reuters_dnn")


def make_smallnet(name: str, **kw) -> SmallNet:
    if name == "mnist_cnn":
        return SmallNet("mnist_cnn", functools.partial(init_mnist_cnn, **kw),
                        apply_mnist_cnn, "image", kw.get("n_classes", 10))
    if name == "tiny_mlp":
        return SmallNet("tiny_mlp", functools.partial(init_tiny_mlp, **kw),
                        apply_tiny_mlp, "image", kw.get("n_classes", 10))
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP Queue 1, small models)")
    raise ValueError(name)
