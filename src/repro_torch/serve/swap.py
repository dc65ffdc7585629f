"""Live weight hot-swap: `FedEngine` -> `ServeEngine` (mirrors
``repro/serve/swap.py``).

The federated trainer periodically produces a new distilled global model
(`algo.eval_params(state)` — for DS-FL the mean client model trained on the
shared distillation logits).  `attach` wires a `WeightSync` observer into
`FedEngine.on_chunk`, so at every ``chunk_rounds`` boundary the serving
engine's weights are swapped in place:

  * the incoming parameters are checked against the serving ones (names,
    shapes, dtypes; mismatches are named), so a trainer running a
    different config fails loudly instead of serving garbage;
  * `ServeEngine.swap_weights` copies the values into the engine's own
    storage: the served weights never alias the trainer's tensors, which
    the trainers update in place (FedAvg's ``eval_params`` returns *views*
    of the live client stack);
  * responses emitted after the swap are stamped with
    ``weights_version = rounds_done``, so a client can tell which round's
    model produced its tokens;
  * swaps land only at decode-**chunk** boundaries, mirroring the
    `on_chunk` discipline on the training side: `ServeEngine.step` syncs
    its fused chunk before returning, so a swap can never interleave with
    an in-flight chunk — every token inside one chunk comes from a single
    weights version.

The swap latency is host time around the copy and a synchronize of the
serving device (none on the CPU).

`swap_from_checkpoint` is the offline variant: load a params tree saved
with `checkpoint.save_pytree` (by either package) and hot-swap it into a
running server.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from .. import obs
from ..checkpoint import load_pytree
from .engine import ServeEngine


def _sync(engine: ServeEngine) -> None:
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def _flat(tree, prefix: str = "", out=None) -> dict:
    """A nested dict of tensors (the reference's layout) as the port's flat
    ``{"a/b": tensor}``; a flat dict comes back as it is."""
    out = {} if out is None else out
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(v, f"{prefix}{k}/", out)
        else:
            out[f"{prefix}{k}"] = v
    return out


@dataclass
class WeightSync:
    """`FedEngine.on_chunk` observer that hot-swaps a `ServeEngine`.

    ``every``: swap at every ``every``-th completed round that on_chunk
    reports (on_chunk already fires only at chunk boundaries; this thins it
    further).  ``swap_log`` records ``(round, seconds)`` per swap — the
    measured swap latency."""
    serve: ServeEngine
    algo: object                        # FedAlgorithm (eval_params provider)
    every: int = 1
    swap_log: list = field(default_factory=list)

    def __call__(self, rounds_done: int, state) -> None:
        if rounds_done % max(1, int(self.every)) != 0:
            return
        with obs.span("swap.sync", "swap", round=rounds_done) as sp:
            params, _ = self.algo.eval_params(state)
            t0 = time.perf_counter()
            self.serve.swap_weights(params, version=rounds_done)
            _sync(self.serve)
            dt = time.perf_counter() - t0
            # the decode-chunk boundary the swap landed at: every token of
            # a fused chunk decodes under one weights version
            sp.set(swap_s=dt, serve_steps=self.serve.n_steps)
        self.swap_log.append((int(rounds_done), dt))
        reg = obs.current_registry()
        if reg is not None:
            reg.histogram("swap.latency_s").observe(dt)

    @property
    def last_swap_s(self) -> Optional[float]:
        return self.swap_log[-1][1] if self.swap_log else None


def attach(fed_engine, serve_engine: ServeEngine, algo,
           every: int = 1) -> WeightSync:
    """Install a `WeightSync` as ``fed_engine.on_chunk`` and return it.
    ``algo`` is the algorithm instance the trainer runs (its ``eval_params``
    extracts the servable global model from the round state)."""
    sync = WeightSync(serve=serve_engine, algo=algo, every=every)
    fed_engine.on_chunk = sync
    return sync


def swap_from_checkpoint(serve_engine: ServeEngine, path: str,
                         version: Optional[int] = None) -> float:
    """Load a params tree (`save_pytree` format, from either package) and
    hot-swap it into a running server; returns the measured swap latency in
    seconds."""
    params = _flat(load_pytree(path))
    t0 = time.perf_counter()
    serve_engine.swap_weights(params, version=version)
    _sync(serve_engine)
    return time.perf_counter() - t0
