"""Wire-format codecs: what crosses the network each round (mirrors
``repro/core/wire.py``).

`comm.CommModel` computes the paper's Table 1/2 byte counts analytically;
this module measures them.  A `Codec` turns an upload payload (a tensor or
a nested dict of tensors: per-sample probabilities for DS-FL, a per-class
table for FD, the parameters for FedAvg) into its encoding on the wire, and
`nbytes` sums the encoded tensors' sizes.  The tests hold
``nbytes(encode(payload)) * (K + 1)`` to ``CommModel.round_bytes(...)``.

The reference measures with ``jax.eval_shape`` at no compute; here a
payload is encoded for real (one client's, a forward pass or the server's
parameters) and its encoded tensors are counted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from .aggregation import topk_compress, topk_decompress
from .trees import tree_leaves, tree_map

F32 = torch.float32


def nbytes(tree) -> int:
    """Total bytes of the tensors of a tree."""
    return sum(math.prod(t.shape) * t.element_size()
               for t in tree_leaves(tree))


def _is_packed(key: str):
    return lambda d: isinstance(d, dict) and key in d


@dataclass(frozen=True)
class Codec:
    """Base codec: identity framing of float32 leaves ("dense-f32").

    ``encode_up``/``encode_down`` are the per-leg encodings (client upload
    vs. server multicast broadcast); symmetric codecs alias both to
    ``encode``, while `AsymmetricCodec` pays each leg differently."""
    name: str = "dense_f32"

    def encode(self, payload):
        return tree_map(lambda a: a.to(F32), payload)

    def decode(self, encoded):
        return tree_map(lambda a: a.to(F32), encoded)

    def encode_up(self, payload):
        return self.encode(payload)

    def encode_down(self, payload):
        return self.encode(payload)

    def decode_up(self, encoded):
        return self.decode(encoded)

    def decode_down(self, encoded):
        return self.decode(encoded)

    def payload_bytes(self, encoded) -> int:
        return nbytes(encoded)


@dataclass(frozen=True)
class DenseF32Codec(Codec):
    name: str = "dense_f32"


@dataclass(frozen=True)
class FP16Codec(Codec):
    """Half-precision exchange: 2 bytes per logit, decoded back to f32."""
    name: str = "fp16"

    def encode(self, payload):
        return tree_map(lambda a: a.to(torch.float16), payload)


@dataclass(frozen=True)
class TopKCodec(Codec):
    """Top-k sparsified exchange over the class axis (beyond paper): each
    leaf (..., C) becomes renormalized ``{"v": (..., k) f32, "i": (..., k)
    int32}``, k*(4+4) bytes a sample instead of C*4.  ``n_classes`` is
    needed to densify on decode."""
    name: str = "topk"
    k: int = 32
    n_classes: int = 10

    def encode(self, payload):
        def enc(a):
            v, i = topk_compress(a.to(F32), self.k)
            return {"v": v, "i": i.to(torch.int32)}
        return tree_map(enc, payload)

    def decode(self, encoded):
        return tree_map(lambda d: topk_decompress(d["v"], d["i"],
                                                  self.n_classes),
                        encoded, is_leaf=_is_packed("v"))


@dataclass(frozen=True)
class Int8Codec(Codec):
    """Per-tensor affine int8 quantization: each leaf becomes ``{"q":
    uint8, "scale": f32 scalar, "zero": f32 scalar}``, 1 byte per logit
    plus an 8-byte (scale, zero) sidecar.  Decode is ``q * scale + zero``;
    the round trip errs by at most ``scale / 2``."""
    name: str = "int8"

    def encode(self, payload):
        def enc(a):
            a = a.to(F32)
            lo, hi = a.min(), a.max()
            scale = torch.clamp(hi - lo, min=1e-12) / 255.0
            q = torch.clamp(torch.round((a - lo) / scale), 0, 255).to(
                torch.uint8)
            return {"q": q, "scale": scale, "zero": lo}
        return tree_map(enc, payload)

    def decode(self, encoded):
        return tree_map(lambda d: d["q"].to(F32) * d["scale"] + d["zero"],
                        encoded, is_leaf=_is_packed("q"))


@dataclass(frozen=True)
class AsymmetricCodec(Codec):
    """Per-leg codec: a cheap uplink from each client and a dense broadcast
    downlink, by default top-k (value, index) pairs up and fp16 down.
    ``encode``/``decode`` alias the uplink leg (the payload
    `FedEngine.measured_round_bytes` multiplies by K)."""
    name: str = "asym"
    up: Codec = field(default_factory=TopKCodec)
    down: Codec = field(default_factory=FP16Codec)

    def encode(self, payload):
        return self.up.encode(payload)

    def decode(self, encoded):
        return self.up.decode(encoded)

    def encode_up(self, payload):
        return self.up.encode(payload)

    def encode_down(self, payload):
        return self.down.encode(payload)

    def decode_up(self, encoded):
        return self.up.decode(encoded)

    def decode_down(self, encoded):
        return self.down.decode(encoded)


CODECS = {"dense_f32": DenseF32Codec, "fp16": FP16Codec, "topk": TopKCodec,
          "int8": Int8Codec, "asym": AsymmetricCodec}


def make_codec(name: str, **kw) -> Codec:
    return CODECS[name](**kw)


def measured_payload_bytes(codec: Codec, payload_fn, *args) -> int:
    """Bytes of ``codec.encode(payload_fn(*args))``, counted on the encoded
    tensors of one real call (no gradients are kept)."""
    with torch.no_grad():
        return nbytes(codec.encode(payload_fn(*args)))
