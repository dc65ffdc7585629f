"""The card's roofline: its published peaks, the least time of a call, and
a step's useful FLOPs (mirrors ``repro/launch/roofline.py``).

  compute    = operations / the peak rate of their type
  memory     = bytes moved / the HBM rate
  collective = each mesh axis's collective bytes / the link its groups span

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense
rates, without sparsity, at the full 700 W power limit; a card set below
it runs slower under load), and a DGX H100's links: eight cards a node on
NVLink 4 (450 GB/s a direction a card), nodes joined by one 400 Gb/s NDR
InfiniBand port a card (50 GB/s).  The reference's constants are a TPU
v5e's and are not used here.

The reference parses collective bytes out of compiled HLO; here
`collective_bytes`, `cross_pod_bytes` and `axis_bytes` (per mesh axis)
sum the collectives log of `launch.collectives` instead (the per-rank
result bytes, the reference's convention).  `Roofline.build` reads a
record of `launch.costs` (FLOPs, bytes, collectives by axis, live peak,
argument bytes: the counterparts of an XLA executable's cost and memory
analyses); `Roofline.from_terms` takes one card's terms and the peak
memory the caller measured (``torch.cuda.max_memory_allocated()``).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
TF32_FLOPS = 495e12           # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS = 989e12           # H100 SXM dense bf16 on the tensor cores
L2_BYTES = 50 * 2 ** 20       # H100 SXM L2 cache
NVLINK_BYTES_PER_S = 450e9    # NVLink 4, a direction a card (DGX H100)
IB_BYTES_PER_S = 50e9         # one 400 Gb/s NDR InfiniBand port a card
NODE_CARDS = 8                # cards a DGX H100 node joins by NVLink


def bound_ms(nbytes: float, flops: float, tf32_flops: float = 0.0):
    """The least time of a call in ms and what sets it: the larger of its
    bytes over the memory rate and its operations over the rate of their
    type (``flops`` fp32 outside the tensor cores, ``tf32_flops`` TF32 on
    them; the two units run side by side).  Returns (ms, "bytes" |
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / FP32_FLOPS, tf32_flops / TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def collective_bytes(log) -> dict[str, int]:
    """Result bytes per collective kind over a `launch.collectives` log."""
    out: dict[str, int] = {}
    for kind, _, nbytes in log:
        out[kind] = out.get(kind, 0) + nbytes
    return out


def cross_pod_bytes(log) -> dict[str, int]:
    """`collective_bytes` of the entries whose group spans pods (their
    axes name "pod": a pod group of more than one rank)."""
    return axis_bytes(log).get("pod", {})


def axis_bytes(log) -> dict[str, dict[str, int]]:
    """{axis: `collective_bytes` of the entries over that axis} ("pod",
    "data", "model"; a one-rank group's entries, which move nothing, under
    "")."""
    out: dict[str, dict[str, int]] = {}
    for kind, axes, nbytes in log:
        per = out.setdefault("/".join(axes), {})
        per[kind] = per.get(kind, 0) + nbytes
    return out


def axis_groups(mesh_shape: dict, axis: str) -> list:
    """The rank groups of ``axis`` on a row-major mesh of ``mesh_shape``
    ({axis: size}, in mesh order), as lists of world ranks."""
    import numpy as np
    names = list(mesh_shape)
    ids = np.arange(int(np.prod(list(mesh_shape.values())))).reshape(
        tuple(mesh_shape.values()))
    d = names.index(axis)
    return np.moveaxis(ids, d, -1).reshape(-1, mesh_shape[axis]).tolist()


def link_rate(mesh_shape: dict, axis: str) -> float:
    """Bytes a second a rank moves over ``axis``: NVLink where every group
    lies in one node of NODE_CARDS consecutive ranks, else InfiniBand."""
    inside = all(len({r // NODE_CARDS for r in g}) == 1
                 for g in axis_groups(mesh_shape, axis))
    return NVLINK_BYTES_PER_S if inside else IB_BYTES_PER_S


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
    mesh: str = "1"
    n_devices: int = 1

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

    @classmethod
    def build(cls, *, arch, shape, mesh_name, step, costs, mesh_shape: dict,
              model_flops):
        """One rank's roofline from a `launch.costs` record (a `Costs` or
        its dict) of its step on a mesh of ``mesh_shape`` ({axis: size}):
        its operations at the bf16 tensor-core rate, its bytes at the HBM
        rate, and each axis's collective bytes at the rate of the link its
        groups span (`link_rate`), the axes one after another.
        ``useful_ratio`` is ``model_flops`` over the FLOPs of every rank."""
        c = costs if isinstance(costs, dict) else costs.to_dict()
        n = 1
        for size in mesh_shape.values():
            n *= size
        coll = {kind: 0 for per in c["coll"].values() for kind in per}
        tx = 0.0
        for axis, per in c["coll"].items():
            for kind, nbytes in per.items():
                coll[kind] += nbytes
            if axis:                  # "": one-rank groups move nothing
                tx += sum(per.values()) / link_rate(mesh_shape, axis)
        tc = c["flops"] / BF16_FLOPS
        tm = c["bytes"] / HBM_BYTES_PER_S
        terms = {"compute": tc, "memory": tm, "collective": tx}
        total = c["flops"] * n
        return cls(arch=arch, shape=shape, step=step, flops=c["flops"],
                   bytes_accessed=c["bytes"],
                   coll_bytes=float(sum(coll.values())),
                   coll_breakdown=coll, t_compute=tc, t_memory=tm,
                   t_collective=tx, bottleneck=max(terms, key=terms.get),
                   model_flops=model_flops,
                   useful_ratio=model_flops / total if total else 0.0,
                   peak_mem_bytes=float(c["peak_bytes"]),
                   arg_bytes=float(c["arg_bytes"]), mesh=mesh_name,
                   n_devices=n)

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
