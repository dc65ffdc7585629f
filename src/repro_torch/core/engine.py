"""`FedEngine`: the federated trainer's per-round loop (mirrors the loop
path of ``repro/core/engine.py``).

Each round the engine draws the shared open batch o_r (the first
``open_batch`` entries of a random permutation of the open set), runs
``algo.round``, scores ``algo.eval_params(state)`` with ``eval_fn`` every
``log_every`` rounds and appends the scalar metrics to ``history``.  All
draws come from one ``torch.Generator`` on the algorithm's ``device``,
seeded with ``hp.seed``; ``run(draws=[RoundDraws, ...])`` injects any of
them per round.

Not ported yet, and refused when asked for: fused multi-round chunks
(``chunk_rounds > 1``), the pipelined schedule (``overlap``), the
participation-sparse plane (``active_budget``); checkpoints, measured wire
bytes and telemetry spans are absent.  ROADMAP Queue 1 lists them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..device import generator
from .algorithms import BatchCtx, RoundState
from .protocol import make_eval_fn  # noqa: F401  (re-exported)


@dataclass
class FedEngine:
    """``eval_fn(params, model_state) -> dict`` is called on
    ``algo.eval_params(state)`` every ``log_every`` rounds; its values join
    the round's scalar metrics in ``history``.  Non-scalar metrics (the
    per-client ``agg_weights``) stay on ``last_metrics``.  The engine runs
    on ``algo.device``."""
    algo: Any
    eval_fn: Optional[Callable] = None
    history: list = field(default_factory=list)
    last_metrics: dict = field(default_factory=dict)
    rounds_done: int = 0

    def __post_init__(self):
        self.gen = generator(self.device, self.algo.hp.seed)

    @property
    def device(self) -> torch.device:
        return self.algo.device

    def init(self, model_init: Callable, data, gen=None) -> RoundState:
        """Fresh training: reseeds the engine's generator and clears
        ``rounds_done`` and ``history``.  Models are drawn from ``gen``
        (default: a generator seeded with ``hp.seed``)."""
        seed = self.algo.hp.seed
        self.gen.manual_seed(seed)
        self.rounds_done = 0
        self.history = []
        return self.algo.init(gen or generator(self.device, seed), model_init,
                              data)

    def make_ctx(self, data, o_idx=None, weights=None) -> BatchCtx:
        return BatchCtx(x=data.x_clients, y=data.y_clients,
                        open_x=data.open_x if self.algo.uses_open else None,
                        o_idx=o_idx, weights=weights)

    def run(self, state: RoundState, data, rounds: Optional[int] = None,
            weights=None, log_every: int = 1, ctx_plan=None, draws=None,
            chunk_rounds: int = 1, overlap: bool = False,
            active_budget: Optional[int] = None) -> RoundState:
        """Run ``rounds`` rounds (default ``hp.rounds``).  ``ctx_plan`` is a
        dict of per-round BatchCtx overrides with a leading (rounds,) axis
        (e.g. ``{"mask": (rounds, K)}``); ``draws`` a list of per-round
        `RoundDraws`."""
        if chunk_rounds != 1 or overlap:
            raise NotImplementedError(
                "chunk_rounds > 1 and overlap=True (fused and pipelined "
                "multi-round execution) are not ported yet: ROADMAP Queue 1, "
                "engine")
        if active_budget is not None:
            raise NotImplementedError(
                "active_budget (the participation-sparse round plane) is not "
                "ported yet: ROADMAP Queue 1, participation-sparse rounds")
        hp = self.algo.hp
        rounds = hp.rounds if rounds is None else rounds
        for f, v in (ctx_plan or {}).items():
            if v.shape[0] < rounds:
                raise ValueError(f"ctx_plan[{f!r}] covers {v.shape[0]} rounds; "
                                 f"run() needs {rounds}")
        if draws is not None and len(draws) < rounds:
            raise ValueError(f"draws cover {len(draws)} rounds; run() needs "
                             f"{rounds}")
        n_open = data.open_x.shape[0]
        n_r = min(hp.open_batch, n_open)
        for i in range(rounds):
            d = None if draws is None else draws[i]
            if d is not None and d.o_idx is not None:
                o_idx = d.o_idx.to(self.device)
            else:
                o_idx = torch.randperm(n_open, generator=self.gen,
                                       device=self.device)[:n_r]
            ctx = self.make_ctx(data, o_idx=o_idx, weights=weights)
            if ctx_plan is not None:
                ctx = dataclasses.replace(
                    ctx, **{f: v[i].to(self.device) for f, v in ctx_plan.items()})
            state, m = self.algo.round(state, ctx, self.gen, d)
            self.last_metrics = m
            self.rounds_done += 1
            if self.rounds_done % log_every == 0:
                rec = {"round": self.rounds_done,
                       **{k: float(v) for k, v in m.items() if v.ndim == 0}}
                if self.eval_fn is not None:
                    rec.update(self.eval_fn(*self.algo.eval_params(state)))
                self.history.append(rec)
        return state
