"""What a step costs, counted as it runs: the port's stand-in for XLA's
``cost_analysis()`` and ``memory_analysis()`` (which the reference's dry
run reads off a compiled executable).

`count(*trees)` is a context manager over any code, on real tensors or on
fake ones (``FakeTensorMode``: enter the mode first, so the factory calls
of the step make fake tensors too), on any device.  It yields a `Costs`
that holds, once the block ends:

  * ``flops``: ``FlopCounterMode``'s count (matmuls, convolutions, and the
    ops of `kernels.library` by their formulas: K5's products, 0 for
    K1-K4);
  * ``bytes``: each op's tensor inputs read and outputs written, summed
    over the ops (a ``TorchDispatchMode``); ops whose outputs alias an
    input without writing it (views, ``detach``, ``expand``: read off
    ``func._schema.returns[i].alias_info``) and factory ops, which take no
    tensor, count nothing, as do queries that return none (a fake
    tensor's ``prim.device``); K1-K5 count `kernels.library.op_bytes`;
  * ``peak_bytes``: the high-water mark of live bytes: the storages of the
    tensors in ``trees`` (the step's arguments, ``arg_bytes``) live from
    the start, and each storage an op creates from then until it is freed
    (``weakref.finalize`` on the untyped storage); ``site_peaks`` (not a
    field) keeps the high-water mark after the ops of each (op, output
    shapes, the package's frames that called it), which
    `launch.dryrun.extrapolate` extrapolates one by one;
  * ``ops``: the calls of each ``repro_torch::`` op, which on the card
    equal `_build.LAUNCHES`' counts of the same run;
  * ``coll``: the collectives the block logged (`launch.collectives.LOG`),
    {axis: {kind: bytes}} by `roofline.axis_bytes`.

Ops are seen where they enter the dispatcher below autograd, so the
backward's ops count too, and an op's own implementation (a kernel's
launch, a plain version) is not looked into: the fake trace and the real
run on the card see the same ops.
"""
from __future__ import annotations

import contextlib
import os
import sys
import weakref
from dataclasses import asdict, dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..kernels import library
from . import collectives
from .roofline import axis_bytes


@dataclass
class Costs:
    flops: int = 0
    bytes: int = 0
    peak_bytes: int = 0
    arg_bytes: int = 0
    ops: dict = field(default_factory=dict)
    coll: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return asdict(self)


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):      # most ops' output
        return [tree]
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


_NOT_SITES = ("costs.py", "dryrun.py")     # the counting, not the step


def _site() -> tuple:
    """The package's frames that led to the op in progress, innermost
    first ((file, line) pairs; empty in autograd's backward of an aten
    op)."""
    out, f = [], sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(_HERE) and not path.endswith(_NOT_SITES):
            out.append((path, f.f_lineno))
        f = f.f_back
    return tuple(out)


class _Live:
    """Live bytes and their high-water mark; a storage counts once."""

    def __init__(self):
        self.now = self.peak = 0
        self.seen = weakref.WeakSet()
        self.sites: dict = {}

    def mark(self, key) -> None:
        """The live bytes after an op of ``key``, kept as that key's
        high-water mark."""
        if self.now > self.sites.get(key, -1):
            self.sites[key] = self.now

    def add(self, t: torch.Tensor) -> int:
        s = t.untyped_storage()
        if s in self.seen:
            return 0
        n = s.nbytes()
        self.seen.add(s)
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(s, self._free, n).atexit = False
        return n

    def _free(self, n: int) -> None:
        self.now -= n


class _Counter(TorchDispatchMode):
    def __init__(self, rec: Costs, live: _Live, sites: bool):
        super().__init__()
        self.rec, self.live, self.sites = rec, live, sites

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rets = func._schema.returns
        outs = _tensors(out)
        if func.namespace == library.NAMESPACE:
            name = func._schema.name.split("::")[1]
            self.rec.ops[name] = self.rec.ops.get(name, 0) + 1
            self.rec.bytes += library.op_bytes(name, *args, *kwargs.values())
        elif outs:
            ins = _tensors((args, kwargs))
            views = all(r.alias_info is not None
                        and not r.alias_info.is_write for r in rets)
            if ins and not views:
                self.rec.bytes += sum(t.nbytes for t in ins + outs)
        per_ret = out if isinstance(out, (tuple, list)) and len(rets) > 1 \
            else (out,)
        for r, o in zip(rets, per_ret):
            if r.alias_info is None:
                for t in _tensors(o):
                    self.live.add(t)
        if self.sites:
            self.live.mark((str(func), tuple((tuple(t.shape), t.dtype)
                                             for t in outs), _site()))
        return out


@contextlib.contextmanager
def count(*trees, sites: bool = True):
    """Count the block's costs (see the module's docstring); ``trees``
    hold the step's arguments, live from the start.  ``sites=False``
    skips ``site_peaks`` (a walk of the Python stack an op), which only
    an extrapolation reads."""
    rec, live = Costs(), _Live()
    for t in _tensors(trees):
        rec.arg_bytes += live.add(t)
    start = len(collectives.LOG)
    flops = FlopCounterMode(display=False)
    try:
        with flops, _Counter(rec, live, sites):
            yield rec
    finally:
        rec.flops = int(flops.get_total_flops())
        rec.peak_bytes = live.peak
        rec.site_peaks = live.sites
        rec.coll = axis_bytes(collectives.LOG[start:])
