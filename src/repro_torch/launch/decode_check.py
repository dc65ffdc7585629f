"""The decode step under a tensor-parallel plan, held against the same
decode in one process (the CPU tests over gloo,
chip_smoke.py's phase "tp decode" on the card, tools/pod_cards.py (f)
across cards).

A `DecodeSpec` names a model (a config, a depth cut, overrides, the
embedding scaled or not), a mesh ("pod", "data", "model") with or without
FSDP, a batch, a prompt fed through decode token by token and a number of
greedy steps after it.  `greedy(spec, params, ...)` decodes from an empty
cache: every step's logits and the greedy tokens; under a plan each rank
holds its slices of the seeded parameters (`launch.tp.TPPlan.slices`) and
its part of the cache, and returns its rows' whole-vocabulary logits.
`rank_main` is one spawned rank's program (`launch.dist.spawn`): its
records carry the logits, the tokens, the collectives of one step by axis
(`roofline.axis_bytes`; `launch.tp.decode_bytes` is their closed form),
ms a step, the peak memory and the kernels' launches of the decode
(`kernels._build.LAUNCHES`, zeroed just before it).  An encoder-decoder's
cache holds the cross keys and values of seeded ``frames``
(`prompt_extras`), which every rank and the one-process run encode alike.
``fault`` plants what a comparison must catch, 3 steps before the end:
rank `FAULT_RANK`'s slice of the first block's ``wo`` (``"wo"``), of its
value ring (``"ring"``), of its Mamba2 ``w_out`` (``"w_out"``), of its SSM
state (``"state"``) or of the first decoder layer's cross values
(``"cross_v"``) 1% off.
`compare` holds a rank's record against the one-process run.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch

from ..configs import get_config
from ..kernels import _build
from ..models.api import model_decode_step, model_init, model_init_cache
from ..models.shardctx import active_plan
from . import collectives
from .roofline import axis_bytes
from .train import extra_inputs

FAULT = 1e-2
FAULT_RANK = 1
FAULT_LEAVES = {"wo": "blocks/s0_mix/wo", "ring": "s0/v",
                "w_out": "blocks/s0_mix/w_out", "state": "s0/state",
                "cross_v": "cross_v"}
_IN_PARAMS = ("wo", "w_out")


@dataclass(frozen=True)
class DecodeSpec:
    arch: str = "phi3-medium-14b"
    smoke: bool = True
    n_layers: Optional[int] = None
    overrides: tuple = ()
    mesh_shape: Optional[tuple] = None     # ("pod", "data", "model")
    fsdp: bool = True
    batch: int = 2
    prompt: int = 1                        # tokens fed through decode
    steps: int = 8                         # greedy tokens after them
    seed: int = 0
    scale_embedding: bool = False          # the embedding times d^-1/2
    fault: Optional[str] = None            # a key of FAULT_LEAVES

    def config(self):
        """The config decoded: ``n_layers`` cuts an encoder-decoder's
        encoder too; an MoE routes each token as a group of its own, as
        `serve.engine.ServeEngine` decodes (ROADMAP, deviation 15), so a
        rank's rows of the batch make whole groups."""
        cfg = get_config(self.arch)
        cfg = cfg.smoke() if self.smoke else cfg
        if self.n_layers is not None:
            cfg = cfg.replace(n_layers=self.n_layers, **(
                {"enc_layers": self.n_layers} if cfg.enc_layers else {}))
        if cfg.n_experts:
            cfg = cfg.replace(moe_group_size=1)
        return cfg.replace(**dict(self.overrides)) if self.overrides else cfg

    @property
    def seq_len(self) -> int:
        """The cache's positions: the tokens decoded, rounded up to a
        multiple of 8 (so a ring splits over up to 8 ranks)."""
        return -(-(self.prompt + self.steps) // 8) * 8

    @property
    def at_step(self) -> int:
        """The step before which ``fault`` is planted, 3 before the end:
        late enough that every rank's ring slots hold values."""
        return self.prompt + self.steps - 3


def init_params(spec: DecodeSpec, device) -> dict:
    """The seeded model every rank and the one-process run start from."""
    cfg = spec.config()
    gen = torch.Generator(device=device).manual_seed(spec.seed)
    params = model_init(cfg, gen, device)
    if spec.scale_embedding:
        with torch.no_grad():
            params["embed/tok"].mul_(cfg.d_model ** -0.5)
    return params


def prompt_tokens(spec: DecodeSpec, device) -> torch.Tensor:
    """(B, prompt) int64 tokens, seeded."""
    gen = torch.Generator().manual_seed(spec.seed + 1)
    vocab = spec.config().vocab
    return torch.randint(0, vocab, (spec.batch, spec.prompt),
                         generator=gen).to(device)


def prompt_extras(spec: DecodeSpec, device) -> dict:
    """The modality inputs the cache is made from: an encoder-decoder's
    seeded ``frames`` (`launch.train.extra_inputs`); none for the other
    families (a VLM's decode reads no patches)."""
    cfg = spec.config()
    if cfg.arch_type != "audio":
        return {}
    gen = torch.Generator(device=device).manual_seed(spec.seed + 2)
    return extra_inputs(cfg, spec.batch, gen)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def greedy(spec: DecodeSpec, params: dict, device, plan=None,
           rows: Optional[slice] = None, fault=None) -> dict:
    """Decode ``spec.prompt`` tokens then ``spec.steps`` greedy ones from
    an empty cache of ``spec.seq_len`` positions (under ``plan`` if given: ``params`` are then the
    rank's slices).  Returns the tokens (B, prompt + steps), the logits of
    every greedy step (steps, B or the rank's ``rows``, V) f32 on the CPU, the
    collectives of the last step by axis, and ms a step after the first.
    ``fault(step, params, cache)`` runs before each step."""
    cfg = spec.config()
    toks = prompt_tokens(spec, device)
    B = spec.batch
    out_tokens = [toks[:, i] for i in range(spec.prompt)]
    logits, times = [], []
    with torch.no_grad(), active_plan(plan):
        cache = model_init_cache(cfg, params, B, spec.seq_len,
                                 prompt_extras(spec, device))
        token = toks[:, 0]
        for step in range(spec.prompt + spec.steps - 1):
            if fault is not None:
                fault(step, params, cache)
            start = len(collectives.LOG)
            _sync(device)
            t0 = time.perf_counter()
            lg, cache = model_decode_step(cfg, params, cache, token,
                                          torch.tensor(step, device=device),
                                          spec.seq_len)
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            step_log = collectives.LOG[start:]
            nxt = token.clone()
            mine = rows if rows is not None else slice(0, B)
            if step + 1 < spec.prompt:
                nxt = toks[:, step + 1]
            else:
                nxt[mine] = lg.argmax(dim=-1)
                out_tokens.append(nxt)
                logits.append(lg.float().cpu())
            token = nxt
    return dict(tokens=torch.stack(out_tokens, dim=1).cpu(),
                logits=torch.stack(logits), step_bytes=axis_bytes(step_log),
                ms_a_step=times[1:], peak_bytes=(
                    torch.cuda.max_memory_allocated()
                    if torch.device(device).type == "cuda" else None))


def _rows(plan, cfg, spec) -> slice:
    """This rank's rows of the batch (all of them unless the cache
    splits the batch over "data")."""
    if not plan.batch_split(spec.batch):
        return slice(0, spec.batch)
    n = spec.batch // plan.data.size
    return slice(plan.data.rank * n, (plan.data.rank + 1) * n)


def _fault(spec: DecodeSpec, rank: int):
    if spec.fault is None or rank != FAULT_RANK:
        return None
    leaf = FAULT_LEAVES[spec.fault]

    def plant(step, params, cache):
        if step == spec.at_step:
            tree = params if spec.fault in _IN_PARAMS else cache
            tree[leaf][0].mul_(1 + FAULT)
    return plant


def run_rank(spec: DecodeSpec, device, full: dict) -> dict:
    """This rank's decode of ``spec`` over ``spec.mesh_shape`` from its
    slices of ``full`` (`init_params`, left as it is)."""
    from .mesh import make_mesh
    from .tp import plan_for
    cfg = spec.config()
    mesh = make_mesh(spec.mesh_shape, device=device)
    plan = plan_for(cfg, mesh, fsdp=spec.fsdp)
    params = {k: v.clone() for k, v in plan.slices(full).items()}
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    rows = _rows(plan, cfg, spec)
    _build.reset_launches()
    rec = greedy(spec, params, device, plan, rows,
                 _fault(spec, plan.data.rank * plan.model.size
                        + plan.model.rank))
    rec["launches"] = dict(_build.LAUNCHES)
    rec["rows"] = (rows.start, rows.stop)
    if rec["peak_bytes"] is not None:
        # the rank's own peak: without the whole model kept for the next
        # spec
        rec["peak_bytes"] -= sum(v.untyped_storage().nbytes()
                                 for v in full.values())
    return rec


def rank_main(rank: int, world: int, specs: tuple, device: str = "cuda"
              ) -> list:
    """One spawned rank: each spec of ``specs`` in turn (`run_rank`), the
    seeded model made once for the specs that share it."""
    from .dist import rank_device
    dev = rank_device(device, rank, world)
    out, made = [], {}
    for spec in specs:
        key = (spec.config(), spec.seed, spec.scale_embedding)
        if key not in made:
            made.clear()
            made[key] = init_params(spec, dev)
        out.append(run_rank(spec, dev, made[key]))
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def compare(rec: dict, one: dict, rtol: float = 1e-5) -> dict:
    """A rank's record against the one-process run: tokens equal, and
    every step's logits of its rows within ``rtol`` of the one-process
    logits' largest magnitude.  Returns the worst difference, the bound
    and whether both hold."""
    lo, hi = rec["rows"]
    ref = one["logits"][:, lo:hi]
    worst = float((rec["logits"] - ref).abs().max())
    bound = rtol * float(ref.abs().max())
    same = bool(torch.equal(rec["tokens"][lo:hi], one["tokens"][lo:hi]))
    return dict(max_abs=worst, bound=bound, tokens_equal=same,
                ok=same and worst <= bound)
