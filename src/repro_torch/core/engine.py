"""`FedEngine`: the federated trainer's per-round loop (mirrors the loop
path of ``repro/core/engine.py``).

Each round the engine draws the shared open batch o_r (the first
``open_batch`` entries of a random permutation of the open set) when the
algorithm uses one, runs ``algo.round``, scores ``algo.eval_params(state)``
with ``eval_fn`` every ``log_every`` rounds and appends the scalar metrics
to ``history``.  All draws come from one ``torch.Generator`` on the
algorithm's ``device``, seeded with ``hp.seed``; ``run(draws=[RoundDraws,
...])`` injects any of them per round.  ``run(active_budget=m)`` makes
masked rounds participation-sparse.  ``measured_round_bytes`` measures a
round's wire bytes through ``codec``.

Not ported yet, and refused when asked for: fused multi-round chunks
(``chunk_rounds > 1``) and the pipelined schedule (``overlap``), ROADMAP
Queue 1 item 2; checkpoints and telemetry spans are absent.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from ..device import generator
from .algorithms import BatchCtx, RoundState
from .protocol import make_eval_fn  # noqa: F401  (re-exported)
from .wire import Codec, DenseF32Codec, nbytes


@dataclass
class FedEngine:
    """``eval_fn(params, model_state) -> dict`` is called on
    ``algo.eval_params(state)`` every ``log_every`` rounds; its values join
    the round's scalar metrics in ``history``.  Non-scalar metrics (the
    per-client ``agg_weights``, FD's global logit) stay on
    ``last_metrics``.  The engine runs on ``algo.device``.

    Host hooks between rounds: ``on_ctx(r, ctx) -> ctx`` rewrites a round's
    BatchCtx before the round (e.g. a scheduler's participation mask),
    ``on_round(r, state) -> state`` rewrites the state after it, and
    ``on_chunk(rounds_done, state)`` observes each new state."""
    algo: Any
    eval_fn: Optional[Callable] = None
    codec: Codec = field(default_factory=DenseF32Codec)
    on_round: Optional[Callable] = None
    on_ctx: Optional[Callable] = None
    on_chunk: Optional[Callable] = None
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

    def make_ctx(self, data, o_idx=None, weights=None,
                 active_budget: Optional[int] = None) -> BatchCtx:
        return BatchCtx(x=data.x_clients, y=data.y_clients,
                        open_x=data.open_x if self.algo.uses_open else None,
                        o_idx=o_idx, weights=weights,
                        active_budget=active_budget)

    def run(self, state: RoundState, data, rounds: Optional[int] = None,
            weights=None, log_every: int = 1, ctx_plan=None, draws=None,
            chunk_rounds: int = 1, overlap: bool = False,
            active_budget: Optional[int] = None) -> RoundState:
        """Run ``rounds`` rounds (default ``hp.rounds``).  ``ctx_plan`` is a
        dict of per-round BatchCtx overrides with a leading (rounds,) axis
        (e.g. ``{"mask": (rounds, K)}``); ``draws`` a list of per-round
        `RoundDraws`.  ``active_budget=m`` computes only the (at most) m
        participants of each masked round; a ``ctx_plan`` mask must then
        give every round between 1 and m participants."""
        if chunk_rounds != 1 or overlap:
            raise NotImplementedError(
                "chunk_rounds > 1 and overlap=True (fused and pipelined "
                "multi-round execution) are not ported yet: ROADMAP Queue 1, "
                "item 2")
        hp = self.algo.hp
        rounds = hp.rounds if rounds is None else rounds
        for f, v in (ctx_plan or {}).items():
            if v.shape[0] < rounds:
                raise ValueError(f"ctx_plan[{f!r}] covers {v.shape[0]} rounds; "
                                 f"run() needs {rounds}")
        if draws is not None and len(draws) < rounds:
            raise ValueError(f"draws cover {len(draws)} rounds; run() needs "
                             f"{rounds}")
        mask_plan = (ctx_plan or {}).get("mask")
        if (active_budget is not None and mask_plan is not None
                and active_budget < mask_plan.shape[-1]):
            # the sparse round's contract, checked on the host before any
            # round runs: too many participants would leave clients that
            # carry aggregation weight uncomputed; none at all would need the
            # uniform fallback's uploads, which the sparse round never makes
            pops = (mask_plan[:rounds] > 0).sum(dim=-1).cpu()
            lo, hi = int(pops.min()), int(pops.max())
            if lo < 1 or hi > active_budget:
                raise ValueError(
                    f"active_budget={active_budget} needs 1 <= participants "
                    f"<= budget every round; ctx_plan masks have [{lo}, {hi}]")
        if self.algo.uses_open:
            n_open = data.open_x.shape[0]
            n_r = min(hp.open_batch, n_open)
        for i in range(rounds):
            r = self.rounds_done
            d = None if draws is None else draws[i]
            o_idx = None
            if d is not None and d.o_idx is not None:
                o_idx = d.o_idx.to(self.device)
            elif self.algo.uses_open:
                o_idx = torch.randperm(n_open, generator=self.gen,
                                       device=self.device)[:n_r]
            ctx = self.make_ctx(data, o_idx=o_idx, weights=weights,
                                active_budget=active_budget)
            if ctx_plan is not None:
                ctx = dataclasses.replace(
                    ctx, **{f: v[i].to(self.device) for f, v in ctx_plan.items()})
            if self.on_ctx is not None:
                ctx = self.on_ctx(r, ctx)
            state, m = self.algo.round(state, ctx, self.gen, d)
            if self.on_round is not None:
                state = self.on_round(r, state)
            self.last_metrics = m
            self.rounds_done = r + 1
            if self.on_chunk is not None:
                self.on_chunk(self.rounds_done, state)
            if self.rounds_done % log_every == 0:
                rec = {"round": self.rounds_done,
                       **{k: float(v) for k, v in m.items() if v.ndim == 0}}
                if self.eval_fn is not None:
                    rec.update(self.eval_fn(*self.algo.eval_params(state)))
                self.history.append(rec)
        return state

    # -------------------------------------------------------- comm bytes ----
    def _payload_ctx(self, data) -> BatchCtx:
        o_idx = None
        if self.algo.uses_open:
            n_r = min(self.algo.hp.open_batch, data.open_x.shape[0])
            o_idx = torch.zeros((n_r,), dtype=torch.long, device=self.device)
        return self.make_ctx(data, o_idx=o_idx)

    def measured_leg_bytes(self, state: RoundState, data) -> tuple[int, int]:
        """(uplink bytes per client, downlink broadcast bytes), counted on
        the encoded tensors of one real payload: ``algo.upload_payload``
        computed once (client 0's probabilities on an open batch of the
        round's size, client 0's per-class table, or the server's model)
        and encoded by ``codec.encode_up`` / ``encode_down``.  No gradients
        are kept."""
        with torch.no_grad():
            payload = self.algo.upload_payload(state, self._payload_ctx(data))
            return (nbytes(self.codec.encode_up(payload)),
                    nbytes(self.codec.encode_down(payload)))

    def measured_round_bytes(self, state: RoundState, data) -> int:
        """Per-round wire bytes under ``codec``: K client uploads and one
        multicast broadcast, `comm.CommModel`'s convention."""
        up, down = self.measured_leg_bytes(state, data)
        return up * data.x_clients.shape[0] + down
