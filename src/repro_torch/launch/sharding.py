"""Per-leaf partition specs (mirrors ``repro/launch/sharding.py``, rule for
rule): Megatron TP over "model", FSDP over "data", expert parallelism over
"model", and the DS-FL federated-client axis "pod".

A spec is a tuple with one entry per dimension of its leaf: ``None``
(replicated), an axis name, or a tuple of two or more names (sharded over
their product, the first the major one) -- the entries of the reference's
``PartitionSpec`` in its canonical form.  The rules are name based and divisibility guarded: a
dimension is sharded over an axis only when it divides evenly, else it is
replicated.  They walk the port's trees: the flat ``/``-joined parameter
dict (a leaf's name is its last segment; a leaf under "blocks", "enc" or
"dec" has a leading stacked-layer axis), and nested dicts, lists and tuples
of tensors (list and tuple positions are not names, as in the reference's
key paths).  A leaf is anything with a ``.shape``; a mesh is a
``DeviceMesh`` or any stand-in `launch.mesh.axis_sizes` reads.

`to_placements` turns a spec into DTensor placements (the counterpart of
``to_named``), and `local_slice` gives one rank's part of a leaf.  The
LLM rounds execute these layouts with explicit collectives: the "pod" axis
in `core.llm_dsfl`, "model" and "data" in `launch.tp` (every family).
`model_shapes` gives one model's full leaf shapes, which the rules read
wherever a rank holds only its slices.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from types import SimpleNamespace

from ..models.base import ModelConfig
from .mesh import axis_size, axis_sizes

_STACK_KEYS = ("blocks", "enc", "dec")


def stack_of(name: str) -> str | None:
    """The stack of `_STACK_KEYS` a flat leaf name lies in (``blocks``,
    ``enc`` or ``dec``), or None for a leaf outside them."""
    head = name.split("/", 1)[0]
    return head if head in _STACK_KEYS and "/" in name else None


def stack_depth(cfg, stack: str) -> int:
    """The blocks of a stack: ``cfg.n_blocks`` pattern-repeats, or the
    encoder-decoder's ``enc_layers`` encoder and ``n_layers`` decoder
    blocks."""
    return {"blocks": cfg.n_blocks, "enc": cfg.enc_layers,
            "dec": cfg.n_layers}[stack]


def _entry(axes) -> object:
    """A spec entry naming ``axes``: None, the one name, or their tuple
    (``PartitionSpec``'s canonical form)."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def _ok(dim_size: int, axis_size: int) -> bool:
    return axis_size > 1 and dim_size % axis_size == 0 and dim_size >= axis_size


class Ruler:
    def __init__(self, cfg: ModelConfig, mesh, fsdp: bool = True):
        self.cfg = cfg
        self.d = axis_size(mesh, "data") if fsdp else 1
        self.m = axis_size(mesh, "model")
        c = cfg
        self.q_tp = _ok(c.eff_heads, self.m) if c.n_heads else False
        self.kv_tp = _ok(c.eff_kv_heads, self.m) if c.n_kv_heads else False
        # attention TP only when both q and kv heads split evenly (GQA
        # groups stay aligned to shards)
        self.attn_tp = self.q_tp and self.kv_tp

    def D(self, n):     # FSDP data-axis candidate
        return "data" if _ok(n, self.d) else None

    def M(self, n):     # TP model-axis candidate
        return "model" if _ok(n, self.m) else None

    def leaf(self, name: str, shape: tuple) -> tuple:
        s = shape
        if name == "tok":
            return (self.M(s[0]), self.D(s[1]))
        if name == "unembed":
            return (self.D(s[0]), self.M(s[1]))
        if name in ("wq", "wk", "wv"):
            return (self.D(s[0]), self.M(s[1]) if self.attn_tp else None)
        if name in ("bq", "bk", "bv"):
            return (self.M(s[0]) if self.attn_tp else None,)
        if name == "wo":
            return (self.M(s[0]) if self.attn_tp else None, self.D(s[1]))
        if name in ("w_gate", "w_up"):
            if len(s) == 3:      # MoE (E, D, F): expert parallel
                return (self.M(s[0]), self.D(s[1]), None)
            return (self.D(s[0]), self.M(s[1]))
        if name == "w_down":
            if len(s) == 3:      # (E, F, D)
                return (self.M(s[0]), self.D(s[1]), None)
            return (self.M(s[0]), self.D(s[1]))
        if name == "b_up":
            return (self.M(s[0]),)
        if name == "router":
            return (None, None)
        if name in ("w_z", "w_x", "w_b", "w_c", "w_dt"):
            return (self.D(s[0]), self.M(s[1]))
        if name in ("cw_x", "cw_b", "cw_c"):
            return (None, self.M(s[1]))
        if name in ("cb_x", "cb_b", "cb_c", "norm_scale"):
            return (self.M(s[0]),)
        if name in ("dt_bias", "a_log", "d_skip"):
            return (self.M(s[0]),)
        if name == "w_out":
            return (self.M(s[0]), self.D(s[1]))
        if name == "pos_dec":
            return (None, self.D(s[1]))
        if name == "w" and len(s) == 2:          # patch projector
            return (self.D(s[0]), self.M(s[1]))
        return (None,) * len(s)                  # norms, biases, misc


def _map_with_keys(fn, tree, keys=()):
    """``fn(keys, leaf)`` over a tree, ``keys`` the leaf's names from the
    root: each dict key split at "/", list/tuple positions and numeric
    segments left out."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(
            fn, v, keys + tuple(p for p in str(k).split("/")
                                if not p.isdigit()))
            for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_keys(fn, v, keys) for v in tree)
    return fn(keys, tree)


def param_specs(cfg: ModelConfig, params, mesh, client_axis=None,
                fsdp: bool = True):
    """The spec tree of ``params`` (tensors, fake tensors, anything with a
    shape).  ``client_axis="pod"`` handles client-stacked leaves, whose
    extra leading axis is sharded over pods.  ``fsdp=False`` keeps the
    parameters TP-only (serving: no weight all-gathers a step)."""
    r = Ruler(cfg, mesh, fsdp=fsdp)

    def rule(keys, leaf):
        shape = tuple(leaf.shape)
        stacked = any(k in _STACK_KEYS for k in keys)
        extra = (client_axis is not None) + stacked
        spec = r.leaf(keys[-1], shape[extra:])
        lead = ((client_axis,) if client_axis is not None else ()) \
            + ((None,) if stacked else ())
        return lead + spec

    return _map_with_keys(rule, params)


@functools.lru_cache(maxsize=None)
def leaf_structs(cfg: ModelConfig) -> tuple:
    """((name, shape, dtype), ...) of one model of ``cfg``: its
    `model_init` run once under fake tensors (no memory), at one
    pattern-repeat (one encoder layer), the stacked leaves' leading axis
    then set to the config's depth (a MoE init draws expert by expert:
    maverick's 48 layers take 36,000 fake ops)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import torch

    from ..models.api import model_init
    one = cfg.replace(n_layers=len(cfg.pattern),
                      **({"enc_layers": 1} if cfg.enc_layers else {}))
    with FakeTensorMode():
        params = model_init(one, torch.Generator(), "cpu")
    out = []
    for k, v in params.items():
        shape = tuple(v.shape)
        stack = k.split("/")[0]
        if stack in _STACK_KEYS:
            assert shape[0] == 1, (k, shape)
            shape = (stack_depth(cfg, stack),) + shape[1:]
        out.append((k, shape, v.dtype))
    return tuple(out)


def _shapes(cfg: ModelConfig) -> tuple:
    return tuple((k, s) for k, s, _ in leaf_structs(cfg))


def model_shapes(cfg: ModelConfig, lead: tuple = ()) -> dict:
    """{leaf: a stand-in with the full ``.shape``} of one model of ``cfg``
    (made under fake tensors, no memory), each shape after ``lead``."""
    return {k: SimpleNamespace(shape=tuple(lead) + s)
            for k, s in _shapes(cfg)}


def cache_specs(cfg: ModelConfig, cache, mesh, batch: int,
                client_axis=None):
    """Decode-cache specs: batch over "data" when divisible; KV heads over
    "model" when divisible, else the cache's sequence dimension over the
    spare axes (long-context batch-1 decode shards the ring itself)."""
    r = Ruler(cfg, mesh)
    b_ax = "data" if _ok(batch, r.d) else None

    def rule(keys, leaf):
        name, s = keys[-1], tuple(leaf.shape)
        lead = (client_axis,) if client_axis else ()
        if name in ("k", "v", "cross_k", "cross_v"):
            # (L, B, W, Kh, hd)
            kh_ax = "model" if _ok(s[3], r.m) else None
            w_candidates = []
            if b_ax is None and _ok(s[2], r.d):
                w_candidates.append("data")
            if kh_ax is None and _ok(s[2], r.m):
                w_candidates.append("model")
            return lead + (None, b_ax, _entry(w_candidates), kh_ax, None)
        if name == "state":      # (L, B, H, P, N)
            return lead + (None, b_ax, "model" if _ok(s[2], r.m) else None,
                           None, None)
        if name in ("conv_x", "conv_b", "conv_c"):   # (L, B, w-1, C)
            return lead + (None, b_ax, None,
                           "model" if _ok(s[3], r.m) else None)
        return (None,) * len(s)

    return _map_with_keys(rule, cache)


def batch_specs(batch_tree, mesh, client_axis=None,
                vocab_axis_on: str = "model"):
    """Input batch specs: the batch dimension over ("pod", "data") as
    divisible; a trailing vocabulary-sized dimension (teacher
    probabilities) over "model"."""
    r_d = axis_size(mesh, "data")
    r_p = axis_size(mesh, "pod") if client_axis is None else 1
    r_m = axis_size(mesh, "model")

    def rule(keys, leaf):
        s = tuple(leaf.shape)
        lead = (client_axis,) if client_axis else ()
        off = 1 if client_axis else 0
        if len(s) == off:       # scalar (pos)
            return lead
        b = s[off]
        baxes = []
        if client_axis is None and r_p > 1 and b % (r_p * r_d) == 0:
            baxes = ["pod", "data"]
        elif _ok(b, r_d):
            baxes = ["data"]
        spec = [_entry(baxes)]
        spec += [None] * len(s[off + 1:-1])
        if len(s) > off + 1:
            spec.append(vocab_axis_on if (s[-1] > 1024 and _ok(s[-1], r_m))
                        else None)
        return lead + tuple(spec)

    return _map_with_keys(rule, batch_tree)


def _axes(entry) -> tuple:
    """The mesh axes one spec entry names."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(mesh, spec) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh axis,
    ``Shard(d)`` for the dimension d whose entry names it, else
    ``Replicate()``.  A dimension over several axes needs them in mesh
    order (DTensor shards mesh dimension after mesh dimension, which is
    the reference's major-to-minor order only then)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    where = {}
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} of dimension {d} names "
                             f"its axes out of the mesh's order {names}")
        for a in axes:
            where[a] = d
    return [Shard(where[a]) if a in where else Replicate() for a in names]


def mesh_coords(mesh, rank: int) -> dict:
    """{axis name: coordinate} of ``rank`` (row-major over the mesh, as
    ``init_device_mesh`` lays out the world)."""
    coords, rest = {}, rank
    sizes = axis_sizes(mesh)
    for name in reversed(list(sizes)):
        coords[name] = rest % sizes[name]
        rest //= sizes[name]
    return coords


def local_slice(tensor, spec, mesh, rank: int):
    """Rank ``rank``'s part of a leaf laid out by ``spec`` (a view): each
    sharded dimension cut into the product of its axes' sizes, the piece
    at the rank's mixed-radix coordinate over those axes."""
    sizes, coords = axis_sizes(mesh), mesh_coords(mesh, rank)
    out = tensor
    for d, entry in enumerate(spec):
        n, i = 1, 0
        for a in _axes(entry):
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        if n == 1:
            continue
        size = out.shape[d]
        if size % n:
            raise ValueError(f"dimension {d} of size {size} does not split "
                             f"over {entry!r} ({n} shards)")
        out = out.narrow(d, i * (size // n), size // n)
    return out


def local_shape(shape: tuple, spec: tuple, mesh) -> tuple:
    """The shape of a rank's `local_slice` of a leaf of ``shape`` laid out
    by ``spec`` (every rank's is the same)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        n = 1
        for a in _axes(entry):
            n *= sizes[a]
        if out[d] % n:
            raise ValueError(f"dimension {d} of size {out[d]} does not "
                             f"split over {entry!r} ({n} shards)")
        out[d] //= n
    return tuple(out)


def local_cache_shapes(cfg: ModelConfig, shapes: dict, mesh,
                       batch: int) -> dict:
    """{leaf: a rank's shape} of a decode cache whose full leaf shapes are
    ``shapes``, under `cache_specs` (the layout a decode step under a
    `launch.tp` plan reads)."""
    specs = cache_specs(cfg, {k: SimpleNamespace(shape=tuple(v))
                              for k, v in shapes.items()}, mesh, batch)
    return {k: local_shape(tuple(v), specs[k], mesh)
            for k, v in shapes.items()}


@dataclass(frozen=True)
class RankSlice:
    """A leaf's placement seen from one rank (the counterpart of a
    ``NamedSharding`` for a restore): ``local(tensor)`` is the rank's part."""
    mesh: object
    spec: tuple
    rank: int

    def local(self, tensor):
        return local_slice(tensor, self.spec, self.mesh, self.rank)
