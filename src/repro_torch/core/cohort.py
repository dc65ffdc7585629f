"""The host-side client store and slab planning of cohort rounds (mirrors
``repro/core/cohort.py``).

The cohort plane (`BatchCtx.cohort`) keeps only the sampled clients on the
device.  A `ClientStore` holds the state of every client touched so far on
the host, keyed by global id, and hands the engine an (S, ...) slab at the
start of a chunk, taking it back at the end.  A client never seen before is
made on its first gather by ``init_fn(ids)`` (e.g. ``algo.init_cohort``),
which draws row g from g's own keyed generator: the row a dense ``init``
would have made.  Host memory is O(touched clients), device memory O(S),
whatever the fleet size K.

Each gather stacks the rows of one leaf into one staging tensor and moves
it to the device in one copy; each scatter brings a leaf back in one copy
and keeps its rows as views of it.

Slab layout (`build_slab` / `slab_ctx_plan`): one slab of fixed size S
serves a whole chunk: the sorted union of the chunk's cohorts, padded with
copies of the first id.  Pad lanes have mask 0 in every round and are
never written back.  Sorted lanes keep the dense round's lane order, and
the rounds' cross-client sums run lane after lane (`lanes.lane_sum`), so
a slab round equals the dense masked round bitwise on the CPU.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint import load_pytree, named_leaves, save_pytree, with_leaves
from ..device import resolve_device
from ..obs import trace as obs


class ClientStore:
    """Host-side rows of client state by global id, made lazily.

    ``init_fn(ids)`` builds a stacked `ClientState` for an (m,) int64
    array of global ids, on any device.  Rows are kept as CPU tensors;
    `gather` returns the stacked slab on ``device`` (default: the card,
    which raises where there is none)."""

    def __init__(self, init_fn: Callable, device="cuda"):
        self.init_fn = init_fn
        self.device = resolve_device(device)
        self._rows: dict[int, list] = {}
        self._like = None            # a one-lane state: names and structure

    def __len__(self) -> int:
        return len(self._rows)

    def ids(self) -> np.ndarray:
        return np.array(sorted(self._rows), np.int64)

    def resident_bytes(self) -> int:
        """Host bytes of all stored client rows."""
        return sum(t.numel() * t.element_size()
                   for row in self._rows.values() for t in row)

    def _insert(self, ids: np.ndarray, slab) -> None:
        if self._like is None:
            self._like = with_leaves(slab, [v[:1].to("cpu", copy=True)
                                            for _, v in named_leaves(slab)])
        leaves = [v.to("cpu") for _, v in named_leaves(slab)]
        for j, cid in enumerate(ids):
            self._rows[int(cid)] = [leaf[j] for leaf in leaves]

    def _stacked(self, ids: np.ndarray) -> list:
        """One CPU staging tensor per leaf, rows in ``ids`` order."""
        rows = [self._rows[int(i)] for i in ids]
        return [torch.stack([r[j] for r in rows])
                for j in range(len(rows[0]))]

    def gather(self, ids):
        """The stacked (len(ids), ...) slab of the given global ids on
        ``device`` (duplicates allowed: pad lanes repeat a real id).
        Missing ids are made through ``init_fn`` in one call, padded to the
        gather size, as the reference pads them."""
        ids = np.asarray(ids, np.int64)
        missing = np.unique([i for i in ids if int(i) not in self._rows])
        if missing.size:
            n_miss = int(missing.size)
            padded = (missing if n_miss >= len(ids) else np.concatenate(
                [missing, np.full(len(ids) - n_miss, missing[0], np.int64)]))
            with obs.span("cohort.lazy_init", "cohort", n=n_miss):
                self._insert(missing, self.init_fn(padded))
        reg = obs.current_registry()
        if reg is not None:
            reg.counter("cohort.gathers").inc()
            reg.counter("cohort.lazy_inits").inc(int(missing.size))
            reg.gauge("cohort.touched_clients").set(len(self._rows))
        return with_leaves(self._like, [t.to(self.device) for t in
                                        self._stacked(ids)])

    def scatter(self, ids, slab, n_real: Optional[int] = None) -> None:
        """Write slab rows back: lane s becomes the stored state of client
        ``ids[s]`` for s < n_real only; pad lanes never touch the store."""
        ids = np.asarray(ids, np.int64)
        n = len(ids) if n_real is None else int(n_real)
        self._insert(ids[:n], slab)
        reg = obs.current_registry()
        if reg is not None:
            reg.counter("cohort.scatters").inc()

    # ---------------------------------------------------------- checkpoint --
    def save(self, path: str) -> None:
        """``{"ids", "leaves"}``, the reference's store layout."""
        ids = self.ids()
        leaves = self._stacked(ids) if ids.size else []
        save_pytree(path, {"ids": ids, "leaves": leaves})

    def load(self, path: str) -> None:
        raw = load_pytree(path)
        self._rows.clear()
        ids = raw["ids"].numpy()
        if ids.size:
            if self._like is None:
                self._like = with_leaves(self.init_fn(ids[:1]), [
                    v[:1].to("cpu") for v in raw["leaves"]])
            self._insert(ids, with_leaves(self._like, raw["leaves"]))


# ------------------------------------------------------------ slab planning --
def build_slab(cohorts: list, slab_size: int):
    """(padded_ids (S,), n_real) for one chunk: the sorted union of the
    chunk's cohort id arrays, padded to ``slab_size`` with copies of the
    first id (mask 0 in every round, never written back)."""
    union = np.unique(np.concatenate([np.asarray(c, np.int64)
                                      for c in cohorts]))
    n_real = int(union.size)
    if n_real > slab_size:
        raise ValueError(f"slab_size {slab_size} < {n_real} distinct "
                         f"cohort ids in this chunk")
    pad = np.full(slab_size - n_real, union[0] if n_real else 0, np.int64)
    return np.concatenate([union, pad]), n_real


def slab_ctx_plan(plans, slab_ids: np.ndarray, n_real: int) -> dict:
    """A chunk of cohort plans on the slab: (k, S) ``mask`` / ``stale``
    plan arrays (numpy) where lane s of round i is 1 iff ``slab_ids[s]``
    is in plan i's cohort.  Pad lanes (s >= n_real) stay 0: their ids
    repeat lane 0's, so membership is decided by lane, never by id."""
    k, S = len(plans), len(slab_ids)
    mask = np.zeros((k, S), np.float32)
    stale = np.zeros((k, S), np.int32)
    real = slab_ids[:n_real]
    for i, p in enumerate(plans):
        lanes = np.searchsorted(real, np.asarray(p.ids, np.int64))
        mask[i, lanes] = 1.0
        stale[i, lanes] = np.asarray(p.staleness, np.int32)
    return {"mask": mask, "stale": stale}
