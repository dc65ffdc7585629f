"""Analytic per-round communication accounting (reproduces paper Tables 1-2).
A copy of ``repro/core/comm.py``, which imports nothing of JAX.

Conventions (matching the paper's numbers exactly):
  * payloads are 32-bit floats (4 bytes);
  * a round's cost = K client uploads + 1 multicast broadcast;
  * DS-FL additionally pays a one-off open-dataset distribution cost
    (ComU@I in Table 3): I_o * sample_bytes, float32 samples;
  * FD uploads per-class logits (C * C floats per client);
  * DS-FL uploads per-sample logits (|o_r| * C floats per client);
  * FL uploads the full parameter vector.
Verified against Table 1/2: e.g. MNIST-CNN FL = 583,242*4*(100+1) = 236 MB,
IMDb FD = 2*2*4*(10+1) = 176 B, Reuters DS-FL = 1000*46*4*(10+1) = 2.0 MB.
"""
from __future__ import annotations

from dataclasses import dataclass

FLOAT_BYTES = 4
HALF_BYTES = 2
INT_BYTES = 4
INT8_BYTES = 1


@dataclass(frozen=True)
class CommModel:
    n_clients: int
    n_classes: int
    n_params: int
    open_batch: int = 1000       # |o_r|

    # ---- per-round costs (bytes) ----
    def fl_round(self) -> int:
        return self.n_params * FLOAT_BYTES * (self.n_clients + 1)

    def fd_round(self) -> int:
        payload = self.n_classes * self.n_classes * FLOAT_BYTES
        return payload * (self.n_clients + 1)

    def dsfl_round(self) -> int:
        payload = self.open_batch * self.n_classes * FLOAT_BYTES
        return payload * (self.n_clients + 1)

    def dsfl_topk_round(self, k: int) -> int:
        """Beyond-paper sparsified exchange: k (value, index) pairs/sample."""
        payload = self.open_batch * k * (FLOAT_BYTES + INT_BYTES)
        return payload * (self.n_clients + 1)

    def dsfl_fp16_round(self) -> int:
        """Beyond-paper half-precision logit exchange."""
        payload = self.open_batch * self.n_classes * HALF_BYTES
        return payload * (self.n_clients + 1)

    def dsfl_int8_round(self) -> int:
        """Beyond-paper affine-quantized logit exchange: 1 byte per logit
        plus the per-tensor (scale, zero) fp32 sidecar (`wire.Int8Codec`)."""
        payload = (self.open_batch * self.n_classes * INT8_BYTES
                   + 2 * FLOAT_BYTES)
        return payload * (self.n_clients + 1)

    def round_bytes(self, method: str, topk: int | None = None) -> int:
        if method == "fl":
            return self.fl_round()
        if method == "fd":
            return self.fd_round()
        if method in ("dsfl", "dsfl_sa", "dsfl_era"):
            return self.dsfl_round()
        if method == "dsfl_topk":
            return self.dsfl_topk_round(topk or 32)
        if method == "dsfl_fp16":
            return self.dsfl_fp16_round()
        if method == "dsfl_int8":
            return self.dsfl_int8_round()
        if method == "single":
            return 0
        raise ValueError(method)

    # ---- one-off costs ----
    def open_set_distribution(self, n_open_total: int, sample_floats: int) -> int:
        """ComU@I: multicast of the unlabeled open dataset."""
        return n_open_total * sample_floats * FLOAT_BYTES


def fmt_bytes(b: float) -> str:
    for unit in ("B", "kB", "MB", "GB", "TB"):
        if abs(b) < 1000:
            return f"{b:.1f} {unit}"
        b /= 1000
    return f"{b:.1f} PB"
