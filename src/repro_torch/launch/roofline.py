"""The card's roofline: its published peaks, the least time of a call, and
a step's useful FLOPs (mirrors the single-device half of
``repro/launch/roofline.py``).

  compute = operations / the peak rate of their type
  memory  = bytes moved / the HBM rate

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense
rates, without sparsity, at the full 700 W power limit; a card set below
it runs slower under load).  The reference's constants are a TPU v5e's and
are not used here.

The reference also parses collective bytes out of compiled HLO and builds
a `Roofline` from an XLA executable's cost and memory analyses; those
belong to the multi-device meshes and are not ported.  Here the caller
passes the terms, and the peak memory it measured
(``torch.cuda.max_memory_allocated()`` on the card).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12           # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS = 989e12           # H100 SXM dense bf16 on the tensor cores
L2_BYTES = 50 * 2 ** 20       # H100 SXM L2 cache


def bound_ms(nbytes: float, flops: float, tf32_flops: float = 0.0):
    """The least time of a call in ms and what sets it: the larger of its
    bytes over the memory rate and its operations over the rate of their
    type (``flops`` fp32 outside the tensor cores, ``tf32_flops`` TF32 on
    them; the two units run side by side).  Returns (ms, "bytes" |
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS, tf32_flops / TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclass
class Roofline:
    arch: str
    shape: str
    step: str
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_breakdown: dict
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: float            # 6 * N_active * tokens "useful" flops
    useful_ratio: float           # model_flops / flops
    peak_mem_bytes: float
    arg_bytes: float

    @classmethod
    def from_terms(cls, *, arch, shape, step, flops, bytes_accessed,
                   model_flops, peak_mem_bytes, arg_bytes):
        """One device's roofline from its step's operations (at the bf16
        rate on the tensor cores) and bytes; no collective term on one
        card."""
        tc = flops / BF16_FLOPS
        tm = bytes_accessed / HBM_BYTES_PER_S
        terms = {"compute": tc, "memory": tm, "collective": 0.0}
        return cls(arch=arch, shape=shape, step=step, flops=flops,
                   bytes_accessed=bytes_accessed, coll_bytes=0.0,
                   coll_breakdown={}, t_compute=tc, t_memory=tm,
                   t_collective=0.0, bottleneck=max(terms, key=terms.get),
                   model_flops=model_flops,
                   useful_ratio=model_flops / flops if flops else 0.0,
                   peak_mem_bytes=float(peak_mem_bytes),
                   arg_bytes=float(arg_bytes))

    def to_dict(self):
        return asdict(self)


def model_flops_estimate(cfg, shape) -> float:
    """6 * N_active * tokens (training) or 2 * N_active * tokens (fwd-only).
    N_active counts each token's parameter traffic (MoE: top_k experts)."""
    d = cfg.d_model
    n_attn = sum(1 for m, _ in cfg.pattern if m == "attn") * cfg.n_blocks
    n_mamba = sum(1 for m, _ in cfg.pattern if m == "mamba") * cfg.n_blocks
    n_mlp = sum(1 for _, f in cfg.pattern if f == "mlp") * cfg.n_blocks
    n_moe = sum(1 for _, f in cfg.pattern if f == "moe") * cfg.n_blocks
    hd = cfg.hd if cfg.n_heads else 0
    attn_p = (cfg.n_heads * hd * d * 2
              + cfg.n_kv_heads * hd * d * 2) if n_attn else 0
    mlp_mult = 3 if cfg.act in ("swiglu", "geglu") else 2
    mlp_p = mlp_mult * d * cfg.d_ff
    moe_p = mlp_mult * d * cfg.d_ff * max(cfg.top_k, 1)
    di = cfg.d_inner if n_mamba else 0
    gn = cfg.ssm_groups * cfg.ssm_state if n_mamba else 0
    mamba_p = di * d * 3 + gn * d * 2 + cfg.ssm_heads * d if n_mamba else 0
    embed_p = d * cfg.vocab                       # unembed matmul
    n_active = (n_attn * attn_p + n_mlp * mlp_p + n_moe * moe_p
                + n_mamba * mamba_p + embed_p)
    if cfg.arch_type == "audio":
        n_active += cfg.enc_layers * (4 * d * d + mlp_mult * d * cfg.d_ff) \
            + cfg.n_layers * 4 * d * d            # enc + cross-attn
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n_active * tokens)
