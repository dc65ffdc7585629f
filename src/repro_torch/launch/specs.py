"""Fake-tensor stand-ins for every model input (mirrors
``repro/launch/specs.py``, whose ``jax.ShapeDtypeStruct`` leaves these
match in shape and dtype): nothing is allocated.  The dry run
(`launch.dryrun`) traces its steps against them.

Every stand-in is a fake tensor of a ``FakeTensorMode`` (`fake_mode`; pass
one as ``mode`` to make several sets that meet in one trace) on
``device`` ("cuda" by default).  The parameters' names, shapes and dtypes
come from `model_init` run once a config under fake tensors
(`sharding.leaf_structs`).  With ``local=True`` and a mesh
each leaf is one rank's slice (``rank``, default this process's rank in
the world), as `sharding.local_slice` cuts it under `sharding.param_specs`,
`sharding.batch_specs` and `sharding.cache_specs`: a fresh fake tensor of
the slice's shape, so its storage is the slice's bytes.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ..configs.shapes import LONG_CONTEXT_WINDOW, InputShape
from ..models.api import model_init_cache
from ..models.base import ModelConfig
from .sharding import (_axes, _entry, batch_specs, cache_specs, leaf_structs,
                       local_slice, param_specs)

I32, BF16, F32 = torch.int32, torch.bfloat16, torch.float32


def fake_mode() -> FakeTensorMode:
    """A mode for stand-ins and the steps traced on them (constants the
    models make as real tensors are converted as they meet)."""
    return FakeTensorMode(allow_non_fake_inputs=True)


def effective_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """long_500k on full-attention archs runs the sliding-window variant;
    SSM/hybrid run natively."""
    if shape.name == "long_500k" and cfg.arch_type not in ("ssm", "hybrid"):
        return cfg.replace(sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def _device(device) -> torch.device:
    return torch.device(device)


def _local(tree: dict, specs: dict, mesh, rank) -> dict:
    """Each leaf's slice for ``rank``, as a fresh fake tensor."""
    if rank is None:
        import torch.distributed as dist
        rank = dist.get_rank()
    return {k: local_slice(v, specs[k], mesh, rank).clone()
            for k, v in tree.items()}


def params_struct(cfg: ModelConfig, *, device="cuda", mode=None,
                  n_clients: int = 1, local: bool = False, mesh=None,
                  rank=None, fsdp: bool = True) -> dict:
    """One model's parameters (``n_clients > 1``: the client-stacked
    leaves, (n_clients, ...)); ``local``: this rank's slices under
    `param_specs` (the stack's client axis over "pod")."""
    mode = mode or fake_mode()
    dev = _device(device)
    lead = (n_clients,) if n_clients > 1 else ()
    with mode:
        params = {k: torch.empty(lead + shape, dtype=dtype, device=dev)
                  for k, shape, dtype in leaf_structs(cfg)}
        if local:
            specs = param_specs(cfg, params, mesh,
                                client_axis="pod" if n_clients > 1 else None,
                                fsdp=fsdp)
            params = _local(params, specs, mesh, rank)
    return params


def batch_struct(cfg: ModelConfig, batch: int, seq: int, *, device="cuda",
                 mode=None, lead: tuple = ()) -> dict:
    """{"tokens": (batch, seq) int32} (+ a VLM's patches, an audio
    model's frames, bf16); ``lead`` prepends a client axis."""
    mode = mode or fake_mode()
    dev = _device(device)
    lead = tuple(lead)
    with mode:
        b = {"tokens": torch.empty(lead + (batch, seq), dtype=I32,
                                   device=dev)}
        if cfg.arch_type == "vlm":
            b["patches"] = torch.empty(lead + (batch, cfg.n_patches,
                                               cfg.d_model), dtype=BF16,
                                       device=dev)
        if cfg.arch_type == "audio":
            b["frames"] = torch.empty(lead + (batch, cfg.n_audio_frames,
                                              cfg.d_model), dtype=BF16,
                                      device=dev)
    return b


def teacher_struct(cfg: ModelConfig, batch: int, seq: int,
                   topk: int | None = None, *, device="cuda", mode=None):
    """The distillation target: (batch, seq, V) bf16, or top-k's (values
    f32, indices int32) of (batch, seq, k)."""
    mode = mode or fake_mode()
    dev = _device(device)
    with mode:
        if topk is not None:
            return (torch.empty((batch, seq, topk), dtype=F32, device=dev),
                    torch.empty((batch, seq, topk), dtype=I32, device=dev))
        return torch.empty((batch, seq, cfg.eff_vocab), dtype=BF16,
                           device=dev)


def cache_struct(cfg: ModelConfig, batch: int, seq_len: int, *,
                 device="cuda", mode=None, local: bool = False, mesh=None,
                 rank=None) -> dict:
    """An empty decode cache for ``seq_len`` positions (an audio model's
    with the cross keys and values of its frames); ``local``: this rank's
    slices under `cache_specs`."""
    mode = mode or fake_mode()
    dev = _device(device)
    if cfg.arch_type == "audio":
        params = params_struct(cfg, device=dev, mode=mode)
        frames = batch_struct(cfg, batch, 1, device=dev, mode=mode)["frames"]
        with mode:
            cache = model_init_cache(cfg, params, batch, seq_len,
                                     {"frames": frames})
    else:
        from ..models import transformer as T
        with mode:
            cache = T.init_cache(cfg, batch, seq_len, dev)
    if local:
        with mode:
            cache = _local(cache, cache_specs(cfg, cache, mesh, batch), mesh,
                           rank)
    return cache


def _local_batch(tree, mesh, rank, mode, client_axis=None, shared=False):
    """Each leaf's rows for ``rank`` as `batch_specs` cuts them, but whole
    sequences and whole vocabulary rows (the port's steps take them so;
    `batch_specs` would split a last dimension past 1024 over "model");
    ``shared``: the batch every client of a "pod" group reads, so not
    split over "pod"."""
    specs = batch_specs(tree, mesh, client_axis=client_axis,
                        vocab_axis_on=None)
    if shared:      # a flat dict of leaves
        specs = {k: tuple(_entry([a for a in _axes(e) if a != "pod"])
                          for e in sp) for k, sp in specs.items()}
    with mode:
        if isinstance(tree, tuple):
            return tuple(_local({"v": t}, {"v": s}, mesh, rank)["v"]
                         for t, s in zip(tree, specs))
        if isinstance(tree, dict):
            return _local(tree, specs, mesh, rank)
        return _local({"v": tree}, {"v": specs}, mesh, rank)["v"]


def input_specs(cfg: ModelConfig, shape: InputShape, *, n_clients: int = 1,
                topk: int | None = None, device="cuda", mode=None,
                local: bool = False, mesh=None, rank=None,
                fsdp: bool = True) -> dict:
    """All inputs of the step this (arch x shape) traces, with the
    effective config under "cfg" and the fake mode under "mode":

    train   -> {params, private, open, teacher} (the DS-FL hybrid client
               step; with n_clients > 1 params and private gain a leading
               client axis for the pod round step, and no teacher)
    prefill -> {params, open}                   (the DS-FL prediction pass)
    decode  -> {params, cache, token, pos}      (the decode step)

    ``local``: one rank's slices on ``mesh``: the parameters' and the
    cache's by their rules, the batches' and the teacher's rows over
    ("pod", "data") as `batch_specs` cuts them, but whole sequences and
    whole vocabulary rows (the port's steps take them so: the client step
    distills on whole rows, `core.llm_dsfl`), and the pod round's open
    batch over "data" only (its clients share it); ``token`` and ``pos``
    stay whole (the decode step takes its rows,
    `transformer.decode_step`)."""
    cfg = effective_config(cfg, shape)
    mode = mode or fake_mode()
    B, S = shape.global_batch, shape.seq_len
    kw = dict(device=device, mode=mode)
    lw = dict(local=local, mesh=mesh, rank=rank)
    out = {"cfg": cfg, "mode": mode}
    loc = (lambda t, **k: _local_batch(t, mesh, rank, mode, **k)) if local \
        else (lambda t, **k: t)
    if shape.kind == "train":
        out["params"] = params_struct(cfg, n_clients=n_clients, fsdp=fsdp,
                                      **kw, **lw)
        if n_clients > 1:
            Bc = B // n_clients
            out["private"] = loc(batch_struct(cfg, Bc, S, lead=(n_clients,),
                                              **kw), client_axis="pod")
            out["open"] = loc(batch_struct(cfg, Bc, S, **kw), shared=True)
        else:
            out["private"] = loc(batch_struct(cfg, B, S, **kw))
            out["open"] = loc(batch_struct(cfg, B, S, **kw))
            out["teacher"] = loc(teacher_struct(cfg, B, S, topk, **kw))
    elif shape.kind == "prefill":
        out["params"] = params_struct(cfg, fsdp=fsdp, **kw, **lw)
        out["open"] = loc(batch_struct(cfg, B, S, **kw))
    else:
        out["params"] = params_struct(cfg, fsdp=fsdp, **kw, **lw)
        out["cache"] = cache_struct(cfg, B, S, **kw, **lw)
        with mode:
            out["token"] = torch.empty((B,), dtype=I32,
                                       device=_device(device))
            out["pos"] = torch.empty((), dtype=I32, device=_device(device))
    return out
