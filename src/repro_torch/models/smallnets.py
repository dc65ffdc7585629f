"""The paper's evaluation models (Section 4.1) in PyTorch, functional, over
flat dicts of tensors (mirrors ``repro/models/smallnets.py``).

  * MNIST CNN: 582,410 values at ``image_hw=28, widths=(32, 64), fc=512``,
    counting the BatchNorm running statistics as Keras does; 582,218 of them
    are trainable.
  * F-MNIST CNN: six 3x3 SAME convolutions with BatchNorm, 2,759,976 values
    (2,759,080 trainable).
  * IMDb LSTM: a 20,000 x 32 embedding, a final-state LSTM of 32 units and
    a dense layer to 2 classes, 648,386 values.
  * Reuters DNN: a bag-of-words of 10,000 through dense 512 and 128 with
    BatchNorm to 46 classes, 5,194,670 values (the paper's count).
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


def conv2d(p, name, x, padding="VALID"):
    """Stride-1 convolution of an NCHW activation with an HWIO weight,
    ``"VALID"`` or ``"SAME"`` (odd kernels: (k - 1) / 2 zeros each side)."""
    w = p[f"{name}/w"].permute(3, 2, 0, 1)
    pad = {"VALID": 0, "SAME": "same"}[padding]
    return F.conv2d(x, w, padding=pad) + p[f"{name}/b"][:, None, None]


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


# ------------------------------------------------------------ F-MNIST CNN ----
_FM_WIDTHS = (32, 32, 64, 64, 128, 128)


def init_fmnist_cnn(gen: torch.Generator, n_classes=10, image_hw=28,
                    fc=(382, 192), device="cuda"):
    device = resolve_device(device)
    p, s = {}, {}
    cin = 1
    for i, c in enumerate(_FM_WIDTHS):
        _conv(p, f"c{i}", gen, 3, 3, cin, c, device)
        _bn(p, s, f"bn{i}", c, device)
        cin = c
    hw = image_hw // 4               # SAME convs; pools after pairs 1, 2
    _dense(p, "d1", gen, hw * hw * _FM_WIDTHS[-1], fc[0], device)
    _dense(p, "d2", gen, fc[0], fc[1], device)
    _dense(p, "d3", gen, fc[1], n_classes, device)
    return p, s


def apply_fmnist_cnn(p, s, x, train: bool):
    ns = {}
    h = x.permute(0, 3, 1, 2)
    for i in range(len(_FM_WIDTHS)):
        h = conv2d(p, f"c{i}", h, padding="SAME")
        h, bn = batchnorm(p, s, f"bn{i}", h, train)
        ns.update(bn)
        h = torch.relu(h)
        if i in (1, 3):                      # pools after conv pairs 1 and 2
            h = F.max_pool2d(h, 2, 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # NHWC flatten order
    h = torch.relu(h @ p["d1/w"] + p["d1/b"])
    h = torch.relu(h @ p["d2/w"] + p["d2/b"])
    return h @ p["d3/w"] + p["d3/b"], ns


# -------------------------------------------------------------- IMDb LSTM ----
def init_imdb_lstm(gen: torch.Generator, vocab=20_000, emb=32, hidden=32,
                   n_classes=2, device="cuda"):
    device = resolve_device(device)
    rn = lambda *shape: torch.randn(shape, generator=gen, dtype=F32,
                                    device=device)
    p = {"embed": rn(vocab, emb) * 0.05,
         "wx": rn(emb, 4 * hidden) * emb ** -0.5,
         "wh": rn(hidden, 4 * hidden) * hidden ** -0.5,
         "b": torch.zeros((4 * hidden,), dtype=F32, device=device)}
    _dense(p, "out", gen, hidden, n_classes, device)
    return p, {}


def apply_imdb_lstm(p, s, tokens, train: bool):
    """tokens: (B, S) integers.  A final-state LSTM, then a dense layer.
    The gates are (i, f, g, o) in that order of ``z = x wx + h wh + b``;
    the input products of all S steps are one product ahead of the loop
    over the tokens (the reference's ``lax.scan``)."""
    x = p["embed"][tokens]                           # (B, S, E)
    H = p["wh"].shape[0]
    xw = x @ p["wx"] + p["b"]                        # (B, S, 4H)
    h = c = torch.zeros(xw.shape[:1] + (H,), dtype=xw.dtype,
                        device=xw.device)
    for t in range(xw.shape[1]):
        z = xw[:, t] + h @ p["wh"]
        gates = torch.sigmoid(z)
        g = torch.tanh(z[:, 2 * H:3 * H])
        c = gates[:, H:2 * H] * c + gates[:, :H] * g
        h = gates[:, 3 * H:] * torch.tanh(c)
    return h @ p["out/w"] + p["out/b"], s


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


# ----------------------------------------------------------- Reuters DNN -----
def init_reuters_dnn(gen: torch.Generator, vocab=10_000, n_classes=46,
                     widths=(512, 128), device="cuda"):
    device = resolve_device(device)
    p, s = {}, {}
    _dense(p, "d1", gen, vocab, widths[0], device)
    _bn(p, s, "bn1", widths[0], device)
    _dense(p, "d2", gen, widths[0], widths[1], device)
    _bn(p, s, "bn2", widths[1], device)
    _dense(p, "d3", gen, widths[1], n_classes, device)
    return p, s


def apply_reuters_dnn(p, s, x, train: bool):
    ns = {}
    h = x @ p["d1/w"] + p["d1/b"]
    h, bn1 = batchnorm(p, s, "bn1", h, train)
    h = torch.relu(h)
    h = h @ p["d2/w"] + p["d2/b"]
    h, bn2 = batchnorm(p, s, "bn2", h, train)
    h = torch.relu(h)
    ns.update(bn1)
    ns.update(bn2)
    return h @ p["d3/w"] + p["d3/b"], ns


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


_REGISTRY = {
    "mnist_cnn": (init_mnist_cnn, apply_mnist_cnn, "image", 10),
    "fmnist_cnn": (init_fmnist_cnn, apply_fmnist_cnn, "image", 10),
    "imdb_lstm": (init_imdb_lstm, apply_imdb_lstm, "tokens", 2),
    "reuters_dnn": (init_reuters_dnn, apply_reuters_dnn, "bow", 46),
    "tiny_mlp": (init_tiny_mlp, apply_tiny_mlp, "image", 10),
}


def make_smallnet(name: str, **kw) -> SmallNet:
    if name not in _REGISTRY:
        raise ValueError(name)
    init, apply, kind, n_classes = _REGISTRY[name]
    return SmallNet(name, functools.partial(init, **kw), apply, kind,
                    kw.get("n_classes", n_classes))
