"""Tensor parallelism over "model" and FSDP over "data" for every family
of the reference (dense, ssm, moe, hybrid, the VLM and the
encoder-decoder): the layouts `launch.sharding` gives
the reference's partitioner, executed with explicit Megatron-style
collectives over the mesh's groups (`launch.collectives`, so each one is
logged with its axis and bytes).

This module holds the layout (`TPPlan`, `plan_for`, `gather_leaf`) and the
closed forms of the bytes (`pass_bytes`, `round_bytes`, `decode_bytes`).
A rank holds `sharding.local_slice` of every parameter under
`sharding.param_specs`; the round makes its plan the one the models read
(`models.shardctx.active_plan`), and they stay plain functions over flat
dicts, running `models.shardctx`'s collectives:

  * the embedding is vocab-parallel: ``tok`` holds the rank's rows of the
    vocabulary, a token outside them looks up zeros, and the rows are
    all-reduced over "model" (`reduce_model`);
  * the MLP is Megatron's: ``w_gate``/``w_up``/``b_up`` column-parallel,
    ``w_down`` row-parallel and all-reduced over "model", ``b_down`` added
    once after the reduce; its input passes `copy_to_model` (the identity,
    whose backward all-reduces the input's gradient);
  * attention runs the rank's heads when the rules split them
    (`Ruler.attn_tp`: query and key/value heads both divide, so GQA groups
    stay on one rank), ``wo`` row-parallel and all-reduced; else it is
    replicated on "model", as the rules lay it out;
  * the Mamba2 mixer runs the rank's heads when "model" divides them
    (`TPPlan.ssm_tp`): ``w_z``/``w_x``/``w_dt`` and the per-head and
    per-channel leaves are the rank's, ``w_b``/``w_c`` and their conv
    leaves the rank's columns of G*N, gathered whole after the conv
    (`gather_model_sum`: its backward reduce-scatters) so the rank reads
    the groups its heads use; the gated norm's sum of squares over the
    whole d_inner is all-reduced (`all_reduce_both`), ``w_out`` is
    row-parallel and all-reduced; else the mixer is replicated;
  * the MoE FFN is expert-parallel when "model" divides the experts
    (`TPPlan.ep`): every rank routes every token with the replicated
    router (the same choices, ranks and drops as one process, and the
    same load-balance loss), passes the top-k gates and the tokens through
    `copy_to_model`, runs its E/M experts' slices of the dispatch and
    combine, and all-reduces its partial output; else it is replicated;
  * the VLM's patch projector is column-parallel (``patch_proj/w``'s
    columns over "model"): the rank projects its columns and they are
    gathered whole (`shardctx.gather_columns`, whose backward keeps the
    rank's columns) before the token embeddings join them;
  * the encoder-decoder's encoder blocks are attention and an MLP as
    above; the decoder's cross-attention runs the rank's heads against the
    rank's key/value heads of the encoder states, ``wo`` row-parallel and
    all-reduced; the encoder states enter the decoder through one
    `copy_to_model`, so their gradient, which each rank holds in part
    (through its own ``wk``/``wv`` columns), is summed over "model" once;
  * the unembedding is column-parallel (its padded-vocabulary mask on the
    global columns) and returns the rank's columns; the round gathers
    them over "model" (`gather_vocab`, whose backward keeps the rank's
    columns) before the losses and the softmax, so K1-K4 run on whole rows;
  * FSDP: before each block the block's "data"-sharded leaves are
    all-gathered over "data" (`gather_block`, for each stack of
    `sharding._STACK_KEYS`: ``blocks``, ``enc``, ``dec``; the model's other
    leaves once a pass by `gather_top`); their gradients reduce-scatter in
    the backward, and the gradients of the leaves "data" does not split are
    all-reduced over it.  Each data rank takes its share of a batch
    (`data_rows`, the rule of `sharding.batch_specs`) and scales its loss
    by 1/D, so the summed gradients are the mean's.  A block is a
    checkpoint: the backward's recompute repeats the block's forward
    collectives (`pass_bytes` counts them), and where the pattern has more
    than one sub-layer each sub-layer's own checkpoint repeats them once
    more.

Every rank of a "model" group computes the same logits, losses and
uploads.  Sums split over ranks (row-parallel products, the gradients over
"data") add in another order than one process: a round agrees with the
one-process round to rounding, not bitwise.  The audio and VLM families
raise on a mesh that splits "data" or "model" (ROADMAP, Queue 1 item
2.1's follow-ups), and so does a mixer the rules would cut inside a head.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .collectives import AxisGroup, all_gather, all_reduce_sum, axis_group
from .mesh import axis_size
from .sharding import (Ruler, _axes, _ok, local_cache_shapes, local_slice,
                       model_shapes, param_specs, stack_depth, stack_of)


@dataclass(frozen=True)
class TPPlan:
    """One rank's view of a mesh's "data" and "model" axes for a config:
    the mesh and its groups, which layers the rules split over "model",
    each leaf's spec (one model's, `sharding.param_specs`) and the
    dimension it is split along over "data" (None: replicated)."""
    mesh: object
    data: AxisGroup
    model: AxisGroup
    attn_tp: bool
    mlp_tp: bool
    vocab_tp: bool
    specs: dict          # flat leaf name -> its spec in one model
    data_dims: dict      # flat leaf name -> its "data" dim (block leaves:
                         # within one block) or None
    fsdp: bool = True    # the leaves split over "data" (False: replicated)
    ssm_tp: bool = False  # "model" divides the Mamba2 mixer's heads
    ep: bool = False     # "model" divides the MoE FFN's experts
    proj_tp: bool = False  # the VLM's projector columns over "model"

    # ------------------------------------------------------------ layout --
    def slices(self, params: dict) -> dict:
        """This rank's `local_slice` of each leaf of one whole model."""
        import torch.distributed as dist
        rank = dist.get_rank()
        return {k: local_slice(v, self.specs[k], self.mesh, rank)
                for k, v in params.items()}

    def whole(self, params: dict) -> dict:
        """One model's leaves gathered whole from every rank's slices."""
        return {k: gather_leaf(v, self.specs[k], self.mesh)
                for k, v in params.items()}

    # ------------------------------------------------------ "model" axis --
    def vocab_start(self, local_cols: int) -> int:
        """The first global vocabulary index of this rank's slice."""
        return self.model.rank * local_cols if self.vocab_tp else 0

    def head_start(self, local_heads: int) -> int:
        return self.model.rank * local_heads if self.attn_tp else 0

    def expert_start(self, local_experts: int) -> int:
        """The first global expert of this rank's slice."""
        return self.model.rank * local_experts if self.ep else 0

    # ------------------------------------------------------- "data" axis --
    def data_rows(self, tree: dict) -> dict:
        """This data rank's share of a batch's leading dimension (the
        whole batch where it does not divide: `sharding.batch_specs`)."""
        D, r = self.data.size, self.data.rank
        out = {}
        for k, v in tree.items():
            b = v.shape[0]
            out[k] = v.narrow(0, r * (b // D), b // D) if _ok(b, D) else v
        return out

    def batch_split(self, batch: int) -> bool:
        """Whether "data" splits a batch of ``batch`` rows (`data_rows`,
        and `sharding.cache_specs`' rule for a decode cache)."""
        return _ok(batch, self.data.size)

    def loss_share(self, loss: torch.Tensor) -> torch.Tensor:
        """This rank's part of the mean loss over the data ranks."""
        return loss / self.data.size if self.data.size > 1 else loss

    def check_family(self, cfg) -> None:
        """`check_family` of ``cfg`` on the plan's mesh."""
        check_family(cfg, self.mesh)

    def cache_shapes(self, cfg, shapes: dict, batch: int) -> dict:
        """{leaf: this rank's shape} of a decode cache whose whole leaves
        have ``shapes``, for a global batch of ``batch`` rows
        (`sharding.local_cache_shapes`)."""
        return local_cache_shapes(cfg, shapes, self.mesh, batch)

    def ring(self, cfg, batch: int, window: int) -> "Ring":
        """How `sharding.cache_specs` lays out a decode ring of ``window``
        slots for a global batch of ``batch`` rows on this mesh, from this
        rank (`Ring`)."""
        spec = _ring_spec(cfg, self.mesh, batch, window)
        if (spec[3] == "model") != self.attn_tp:
            raise NotImplementedError(
                f"{cfg.name}: the cache splits the key/value heads over "
                f"'model' but the plan does not split attention (or the "
                f"reverse)")
        groups = {"data": self.data, "model": self.model}
        shards, index = 1, 0
        for a in _axes(spec[2]):
            g = groups[a]
            shards, index = shards * g.size, index * g.size + g.rank
        return Ring(axes=_axes(spec[2]), shards=shards, index=index,
                    window=window)

    def sum_losses(self, losses: torch.Tensor) -> torch.Tensor:
        """The ranks' `loss_share`s summed over "data"."""
        if self.data.size == 1:
            return losses
        return all_reduce_sum(losses.contiguous(), self.data)


# ------------------------------------------------------------- the plan ----
def _data_dims(specs: dict) -> dict:
    """{leaf: the dim its spec splits over "data" (within one block for a
    stacked leaf), or None}."""
    out = {}
    for k, sp in specs.items():
        dims = [d for d, e in enumerate(sp) if "data" in _axes(e)]
        off = 1 if stack_of(k) else 0
        out[k] = dims[0] - off if dims else None
    return out


def plan_for(cfg, mesh, fsdp: bool = True) -> Optional[TPPlan]:
    """The plan of ``cfg`` on ``mesh`` (a ``DeviceMesh``), or None when
    neither "data" nor "model" has more than one rank.  A mixer the rules
    would cut inside a head raises (`check_family`): nothing runs
    replicated in silence.
    ``fsdp=False`` keeps the leaves whole on "data" (`param_specs`'
    option, the reference's serving layout): "data" then splits only the
    batch and, where `sharding.cache_specs` puts it there, a decode
    ring."""
    if axis_size(mesh, "data") == 1 and axis_size(mesh, "model") == 1:
        return None
    check_family(cfg, mesh)
    r = Ruler(cfg, mesh)
    specs = param_specs(cfg, model_shapes(cfg), mesh, fsdp=fsdp)
    ssm_tp, ep = _splits(cfg, r)
    return TPPlan(mesh=mesh, data=axis_group(mesh, "data"),
                  model=axis_group(mesh, "model"), attn_tp=r.attn_tp,
                  mlp_tp=r.M(cfg.d_ff) is not None,
                  vocab_tp=r.M(cfg.eff_vocab) is not None, specs=specs,
                  data_dims=_data_dims(specs), fsdp=fsdp, ssm_tp=ssm_tp,
                  ep=ep, proj_tp=_proj_tp(cfg, r))


def _proj_tp(cfg, r: Ruler) -> bool:
    """Whether the rules split the VLM projector's columns over "model"."""
    return bool(cfg.n_patches) and r.M(cfg.d_model) is not None


def _splits(cfg, r: Ruler) -> tuple:
    """(the Mamba2 mixer's heads split over "model", the MoE FFN's
    experts split over it) under the rules ``r``."""
    mixers = {m for m, _ in cfg.pattern}
    ffns = {f for _, f in cfg.pattern}
    return ("mamba" in mixers and r.M(cfg.ssm_heads) is not None,
            "moe" in ffns and r.M(cfg.n_experts) is not None)


@dataclass(frozen=True)
class Ring:
    """A decode ring's layout under `sharding.cache_specs` seen from one
    rank: the window's slots over ``axes`` (major first), cut into
    ``shards`` of which this rank holds number ``index``: slots [index * W
    / shards, (index + 1) * W / shards).  The key/value heads are split
    over "model" exactly where the plan splits attention, the batch over
    "data" where `TPPlan.batch_split` says."""
    axes: tuple
    shards: int
    index: int
    window: int

    @property
    def local_window(self) -> int:
        return self.window // self.shards

    @property
    def first_slot(self) -> int:
        return self.index * self.local_window


def _ring_spec(cfg, mesh, batch: int, window: int) -> tuple:
    """`cache_specs`' spec of one attention ring (L, B, W, Kh, hd)."""
    from .sharding import cache_specs
    leaf = SimpleNamespace(shape=(1, batch, window, cfg.eff_kv_heads, cfg.hd))
    return cache_specs(cfg, {"s0/k": leaf}, mesh, batch)["s0/k"]


def check_family(cfg, mesh) -> None:
    """Raise NotImplementedError for a Mamba2 mixer whose leaves the rules
    would split other than on head boundaries, over a mesh whose "data"
    or "model" axis has more than one rank; every family runs there."""
    sizes = {a: axis_size(mesh, a) for a in ("data", "model")}
    if max(sizes.values()) == 1:
        return
    if any(m == "mamba" for m, _ in cfg.pattern):
        _check_mixer(cfg, sizes["model"])


def _check_mixer(cfg, m: int) -> None:
    """The rules split d_inner, the heads and B/C's G*N columns over
    "model" each on its own; the plan runs the mixer on whole heads, with
    B and C's columns split exactly where the heads are and a rank's heads
    in whole groups or inside one."""
    heads, inner = _ok(cfg.ssm_heads, m), _ok(cfg.d_inner, m)
    gn = cfg.ssm_groups * cfg.ssm_state
    if inner and not heads:
        raise NotImplementedError(
            f"{cfg.name}: the rules split d_inner {cfg.d_inner} over "
            f"'model' of {m} but not its {cfg.ssm_heads} heads: a head "
            f"would be cut in two")
    hpg, local = cfg.ssm_heads // cfg.ssm_groups, cfg.ssm_heads // m
    if heads and local % hpg and hpg % local:
        raise NotImplementedError(
            f"{cfg.name}: over 'model' of {m} a rank's {local} heads would "
            f"straddle groups of {hpg} heads")
    if heads != _ok(gn, m):
        raise NotImplementedError(
            f"{cfg.name}: over 'model' of {m} the rules split the "
            f"{cfg.ssm_heads} heads {'' if heads else 'not '}but B and C's "
            f"{gn} columns {'not ' if heads else ''}(the plan splits both "
            f"or neither)")


def gather_leaf(t: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """The whole leaf from each rank's `local_slice` under ``spec`` (every
    rank returns it): the minor axis of a dimension first."""
    for d, entry in enumerate(spec):
        for a in reversed(_axes(entry)):
            if axis_size(mesh, a) > 1:
                t = all_gather(t, axis_group(mesh, a), d)
    return t


# ---------------------------------------------------------- closed forms ----
def _rows(b: int, D: int) -> int:
    return b // D if _ok(b, D) else b


def _mesh(shape: tuple):
    return SimpleNamespace(axis_names=("pod", "data", "model"),
                           devices=np.empty(shape))


def _leaves(cfg, shape: tuple, fsdp: bool = True):
    """(name, spec (within one block for a stacked leaf), the blocks it
    stands for, its local values (one block's), their element size) of
    each leaf of one model on a ("pod", "data", "model") mesh of
    ``shape``; a leaf of a stack (`stack_of`) stands for the stack's
    depth (`stack_depth`)."""
    mesh = _mesh(shape)
    sizes = dict(zip(("pod", "data", "model"), shape))
    specs = param_specs(cfg, model_shapes(cfg), mesh, fsdp=fsdp)
    for k, sh in model_shapes(cfg).items():
        sp, n, times = specs[k], math.prod(sh.shape), 1
        stack = stack_of(k)
        if stack:
            times = stack_depth(cfg, stack)
            sp, n = sp[1:], n // times
        split = math.prod(sizes[a] for e in sp for a in _axes(e))
        elt = 4 if k.endswith("/scale") else torch.empty(
            (), dtype=cfg.cdtype).element_size()      # f32 norm scales
        yield k, sp, times, n // split, elt


def _model_bytes(cfg, r: Ruler, rows: int, decode: bool = False,
                 cross: bool = False) -> tuple:
    """({kind: bytes} of one block's forward collectives over "model",
    {kind: bytes} of those only its backward runs) at ``rows`` tokens
    (``decode``: the decode step's, whose B and C leave the conv in f32;
    ``cross``: an encoder-decoder's decoder block, a cross-attention after
    each mixer).  Each sub-layer the rules split: attention, the
    cross-attention, the MLP and the MoE FFN all-reduce their (rows, d)
    output, the Mamba2 mixer gathers B and C whole (rows, G*N each),
    all-reduces its sum of squares (rows,) f32 and its output; in the
    backward each copied input all-reduces its gradient (the MoE's top-k
    gates too, (rows, k) f32; the cross-attention's query input, its
    encoder states' gradient being summed once a pass: `pass_bytes`), B
    and C's gathers reduce-scatter theirs and the sum of squares
    all-reduces its own."""
    e = torch.empty((), dtype=cfg.cdtype).element_size()
    act = rows * cfg.d_model * e
    ssm_tp, ep = _splits(cfg, r)
    split = {"attn": r.attn_tp, "cross": r.attn_tp, "mamba": ssm_tp,
             "mlp": r.M(cfg.d_ff) is not None, "moe": ep, "none": False}
    fwd = {"all-reduce": 0, "all-gather": 0}
    bwd = {"all-reduce": 0, "reduce-scatter": 0}
    for mixer, ffn in cfg.pattern:
        for part in (mixer, "cross", ffn) if cross else (mixer, ffn):
            if not split[part]:
                continue
            fwd["all-reduce"] += act
            bwd["all-reduce"] += act
            if part == "moe":
                bwd["all-reduce"] += rows * cfg.top_k * 4
            if part == "mamba":
                gn = cfg.ssm_groups * cfg.ssm_state
                fwd["all-gather"] += 2 * rows * gn * (4 if decode else e)
                fwd["all-reduce"] += rows * 4
                bwd["reduce-scatter"] += 2 * rows * gn // r.m * e
                bwd["all-reduce"] += rows * 4
    return fwd, bwd


def _stacks(cfg, rows: int, seqs: Optional[int]) -> tuple:
    """((tokens a block of the stack runs on, its blocks, whether it is a
    decoder block with cross-attention), ...) of one pass over ``rows``
    text tokens of ``seqs`` sequences: a VLM's backbone also runs on each
    sequence's patches, an encoder-decoder's encoder on its frames."""
    if cfg.arch_type not in ("vlm", "audio"):
        return ((rows, cfg.n_blocks, False),)
    if seqs is None:
        raise ValueError(f"{cfg.name}: the bytes of a pass need its "
                         f"sequences (the patches or frames each brings)")
    if cfg.arch_type == "vlm":
        return ((rows + seqs * cfg.n_patches, cfg.n_blocks, False),)
    return ((seqs * cfg.n_audio_frames, cfg.enc_layers, False),
            (rows, cfg.n_layers, True))


def pass_bytes(cfg, shape: tuple, rows: int, grad: bool,
               seqs: Optional[int] = None) -> dict:
    """{axis: {kind: bytes}} one rank's collectives move in one model pass
    over ``rows`` text tokens of ``seqs`` sequences (which a VLM's patches
    and an encoder's frames come with; the other families do not read it)
    on a ("pod", "data", "model") mesh of ``shape``: the forward, and with
    ``grad`` the recompute (the block's checkpoint, and each sub-layer's
    own where the pattern has more than one) and the backward.  Derived
    from the rules and the shapes alone."""
    _, D, M = shape
    out: dict = {}

    def add(axis, kind, n):
        per = out.setdefault(axis, {})
        per[kind] = per.get(kind, 0) + n

    if D > 1:
        for k, sp, times, n, elt in _leaves(cfg, shape):
            local = n * elt
            if any("data" in _axes(e) for e in sp):
                # the forward, and a block's recompute in a grad pass
                again = 2 if grad and stack_of(k) else 1
                add("data", "all-gather", local * D * times * again)
                if grad:
                    add("data", "reduce-scatter", local * times)
            elif grad:
                add("data", "all-reduce", local * times)
    if M > 1:
        r = Ruler(cfg, _mesh(shape))
        e = torch.empty((), dtype=cfg.cdtype).element_size()
        act = rows * cfg.d_model * e
        vocab = r.M(cfg.eff_vocab) is not None
        # the forward, and in a grad pass each recompute of a sub-layer
        runs = 1 + grad * (1 + (len(cfg.pattern) > 1))
        for tokens, blocks, cross in _stacks(cfg, rows, seqs):
            fwd, bwd = _model_bytes(cfg, r, tokens, cross=cross)
            for kind, n in fwd.items():
                add("model", kind, runs * blocks * n)
            if grad:
                # the copies' gradient reduces, the gathers' reduce-scatters
                for kind, n in bwd.items():
                    add("model", kind, blocks * n)
        # the embedding's reduce and the logits' gather
        add("model", "all-reduce", vocab * act)
        add("model", "all-gather", vocab * rows * cfg.eff_vocab * e)
        if _proj_tp(cfg, r):
            # the projector's columns gathered (its backward keeps them)
            add("model", "all-gather",
                seqs * cfg.n_patches * cfg.d_model * e)
        if grad:
            # the unembedding's copy; the encoder states' one copy
            add("model", "all-reduce", vocab * act)
            if cfg.arch_type == "audio" and r.attn_tp:
                add("model", "all-reduce",
                    seqs * cfg.n_audio_frames * cfg.d_model * e)
    return merge(out)


def merge(*parts) -> dict:
    """Sum {axis: {kind: bytes}} dicts, each optionally times a count:
    ``(dict, times)`` pairs or plain dicts; zero entries dropped."""
    out: dict = {}
    for p in parts:
        d, times = p if isinstance(p, tuple) else (p, 1)
        for axis, kinds in d.items():
            per = out.setdefault(axis, {})
            for kind, n in kinds.items():
                per[kind] = per.get(kind, 0) + n * times
    out = {a: {k: n for k, n in kinds.items() if n}
           for a, kinds in out.items()}
    return {a: kinds for a, kinds in out.items() if kinds}


def round_bytes(cfg, shape: tuple, *, clients: int, batch: int, seq: int,
                mode: str, lanes_run: int, topk: Optional[int] = None
                ) -> dict:
    """{axis: {kind: bytes}} of one LLM round on one rank of a mesh of
    ``shape`` (axis "" for a one-rank pod group, which moves nothing):
    ``lanes_run`` of the rank's clients predict and train.  DS-FL: each
    lane's prediction pass on the open batch and its two grad passes
    (private CE, open KD); the uploads all-gathered over "pod" (bf16
    distributions, or top-k's f32 values and int32 indices).  FedAvg: one
    grad pass a lane and the f32 all-reduce of the rank's shards over
    "pod".  Both: the lanes' losses summed over "data" and gathered over
    "pod"."""
    P, D, _ = shape
    pod = "pod" if P > 1 else ""
    rows = _rows(batch, D) * seq
    seqs = _rows(batch, D)
    if mode == "dsfl":
        parts = [(pass_bytes(cfg, shape, rows, False, seqs), lanes_run),
                 (pass_bytes(cfg, shape, rows, True, seqs), 2 * lanes_run),
                 {pod: {"all-gather": 2 * clients * rows * topk * 4
                        if topk else clients * rows * cfg.eff_vocab * 2}}]
    else:
        f32_shards = sum(4 * n * times
                         for _, _, times, n, _ in _leaves(cfg, shape))
        parts = [(pass_bytes(cfg, shape, rows, True, seqs), lanes_run),
                 {pod: {"all-reduce": f32_shards}}]
    if D > 1:
        parts.append({"data": {"all-reduce": 4 * (clients // P)}})
    parts.append({pod: {"all-gather": 4 * clients}})
    return merge(*parts)


def decode_bytes(cfg, shape: tuple, *, batch: int, window: int,
                 fsdp: bool = True) -> dict:
    """{axis: {kind: bytes}} one rank's collectives move in one decode
    step of a global ``batch`` against rings of ``window`` slots on a
    ("pod", "data", "model") mesh of ``shape``: FSDP's all-gathers of the
    leaves "data" splits (``fsdp``; not the encoder's, which the step does
    not run), the "model" all-reduces of the embedding and each block's
    row-parallel products (an encoder-decoder's cross-attention too), the
    Mamba2 mixers' B and C gathers (f32) and sums of squares, and the
    logits' all-gather, and, where `sharding.cache_specs` splits the
    window (or an encoder-decoder's cross cache, its ``n_audio_frames``
    encoder positions), each attention layer's merge over each of its
    axes: the all-reduce of the row maxima (B, H) f32, then of the sums
    of exp and the weighted values (B, H, hd + 1) f32."""
    _, D, M = shape
    out: dict = {}

    def add(axis, kind, n):
        per = out.setdefault(axis, {})
        per[kind] = per.get(kind, 0) + n

    if D > 1 and fsdp:
        for k, sp, times, n, elt in _leaves(cfg, shape):
            if any("data" in _axes(e) for e in sp) and stack_of(k) != "enc":
                add("data", "all-gather", n * elt * D * times)
    rows = batch // D if _ok(batch, D) else batch
    e = torch.empty((), dtype=cfg.cdtype).element_size()
    audio = cfg.arch_type == "audio"
    if M > 1:
        r = Ruler(cfg, _mesh(shape))
        act = rows * cfg.d_model * e
        vocab = r.M(cfg.eff_vocab) is not None
        fwd = _model_bytes(cfg, r, rows, decode=True, cross=audio)[0]
        for kind, n in fwd.items():
            add("model", kind, cfg.n_blocks * n)
        add("model", "all-reduce", vocab * act)
        add("model", "all-gather", vocab * rows * cfg.eff_vocab * e)
    n_attn = cfg.n_blocks * sum(m == "attn" for m, _ in cfg.pattern)
    rings = [window] + ([cfg.n_audio_frames] if audio else [])
    for slots in rings if n_attn else ():
        spec = _ring_spec(cfg, _mesh(shape), batch, slots)
        heads = cfg.eff_heads // (M if spec[3] == "model" else 1)
        for a in _axes(spec[2]):
            add(a, "all-reduce", n_attn * rows * heads * 4 * (cfg.hd + 2))
    return merge(out)
