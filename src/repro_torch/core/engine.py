"""`FedEngine`: the federated trainer (mirrors ``repro/core/engine.py``).

Each round the engine draws the shared open batch o_r (the first
``open_batch`` entries of a keyed permutation of the open set, the "open"
leg of `core.prng`) when the algorithm uses one, runs ``algo.round(state,
ctx, r)``, scores ``algo.eval_params(state)`` with ``eval_fn`` every
``log_every`` rounds and appends the scalar metrics to ``history``.  Every
draw of round r is keyed on (hp.seed, r), so a run resumes from
``rounds_done`` alone and can be cut into chunks anywhere;
``run(draws=[RoundDraws, ...])`` injects any draw per round.

``run(chunk_rounds=k)`` runs k rounds at a time with the ``ctx_plan``
sliced per chunk: the per-round scalar metrics stay on the device and
cross to the host once per chunk (one sync a chunk instead of one a
round), and with ``eval_fn`` the chunks end on ``log_every`` boundaries.
``overlap=True`` runs the pipelined schedule: ``round_start`` of the
first round, then ``round_finish(r)`` followed by ``round_start(r + 1)``,
then the last ``round_finish``.  ``algo.round`` is
``round_finish(round_start(...))``, so the calls are the sequential
chunk's; over a mesh ``round_start`` leaves the exchange's gather in
flight and ``round_finish`` waits on it once the private-data CE has run
(a CUDA-graph capture of a chunk is not built).  All schedules give the
same bits.

``FedEngine(mesh=...)`` runs an algorithm that takes a mesh (the LLM
algorithms) over its "pod" ranks: the engine hands the algorithm the mesh,
each rank keeps its part of the round's BatchCtx (cut by
``algo.shardings``), the history is identical on every rank, ``save_state``
gathers the state's leaves whole (over "pod", and over "data" and "model"
where the dense family's layout splits them) to rank 0, which writes the
one file the reference writes, and ``load_state(..., shardings=)`` keeps
each rank's `local_slice` of such a file (or of a one-process one).

``run(active_budget=m)`` makes masked rounds participation-sparse;
``cohort``/``population`` run them over a slab (see `core.algorithms`).
``save_state``/``load_state`` checkpoint the round state, ``rounds_done``
and ``history`` in the reference's msgpack layout (`checkpoint`).
``measured_round_bytes`` measures a round's wire bytes through ``codec``.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..checkpoint import (assert_tree_compatible, load_pytree,
                          named_leaves, nodes_at_leaves, save_pytree,
                          with_leaves)
from ..launch.sharding import RankSlice, _axes, _entry, local_slice
from ..launch.tp import gather_leaf
from ..obs import trace as obs
from . import prng
from .algorithms import BatchCtx, RoundState
from .protocol import make_eval_fn  # noqa: F401  (re-exported)
from .trees import leading_dim
from .wire import Codec, DenseF32Codec, nbytes


def open_batch(seed: int, rnd: int, n_open: int, n_r: int, device
               ) -> torch.Tensor:
    """Round ``rnd``'s o_r: the first ``n_r`` entries of the keyed
    permutation of ``range(n_open)``."""
    return prng.permutation(seed, rnd, "open", 0, n_open, device)[:n_r]


def _off_model(spec: tuple) -> tuple:
    """``spec`` with the "model" axis taken out of every entry."""
    return tuple(_entry([a for a in _axes(e) if a != "model"]) for e in spec)


@dataclass
class FedEngine:
    """``eval_fn(params, model_state) -> dict`` is called on
    ``algo.eval_params(state)`` every ``log_every`` rounds; its values join
    the round's scalar metrics in ``history``.  Non-scalar metrics (the
    per-client ``agg_weights``, FD's global logit) stay on
    ``last_metrics``.  The engine runs on ``algo.device``.

    Host hooks between rounds: ``on_ctx(r, ctx) -> ctx`` rewrites a round's
    BatchCtx before the round (e.g. a scheduler's participation mask) and
    ``on_round(r, state) -> state`` the state after it; either one makes
    the run take one round at a time.  ``on_chunk(rounds_done, state)``
    observes each new state: after every chunk, or every round on the
    loop.  ``mesh`` (a ``DeviceMesh``) runs the algorithm over its "pod"
    ranks; the algorithm must take a ``mesh`` and get this one or none."""
    algo: Any
    eval_fn: Optional[Callable] = None
    codec: Codec = field(default_factory=DenseF32Codec)
    on_round: Optional[Callable] = None
    on_ctx: Optional[Callable] = None
    on_chunk: Optional[Callable] = None
    mesh: Optional[Any] = None
    history: list = field(default_factory=list)
    last_metrics: dict = field(default_factory=dict)
    rounds_done: int = 0

    def __post_init__(self):
        if self.mesh is None:
            return
        held = getattr(self.algo, "mesh", False)
        if held is False or getattr(self.algo, "shardings", None) is None:
            raise ValueError(f"algorithm {self.algo.name!r} does not run "
                             f"over a mesh")
        if held is None:
            self.algo = dataclasses.replace(self.algo, mesh=self.mesh)
        elif held is not self.mesh:
            raise ValueError("the algorithm holds another mesh than the "
                             "engine's")

    @property
    def device(self) -> torch.device:
        return self.algo.device

    @property
    def rank(self) -> int:
        """This process's rank in the world (0 without a mesh)."""
        if self.mesh is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank()

    def _state_specs(self, state: RoundState) -> list:
        """The spec of each state leaf, in `named_leaves` order."""
        specs, _ = self.algo.shardings(self.mesh, state, BatchCtx())
        return nodes_at_leaves(specs, state)

    def local_ctx(self, ctx: BatchCtx, state: RoundState) -> BatchCtx:
        """This rank's part of a BatchCtx: the client-stacked private data
        (``x``, ``y``) cut to the rank's clients by their specs in
        ``algo.shardings``.  Every other field stays whole: each rank's
        clients predict on the whole open batch (the reference's
        data-sharded open set is a layout its partitioner gathers back),
        and the rounds read the (K,) participation fields whole.  The
        identity without a mesh.  The data is cut over "pod" and "data"
        only: the rounds read each input whole on "model" (`batch_specs`
        lays a trailing dimension past 1024, a VLM's patch features too,
        over "model", a layout the reference's partitioner gathers back:
        ROADMAP, deviation 20)."""
        if self.mesh is None:
            return ctx
        _, specs = self.algo.shardings(self.mesh, state, ctx)
        cut = lambda t, sp: local_slice(t, _off_model(sp), self.mesh,
                                        self.rank)
        return dataclasses.replace(ctx, **{
            f: (None if getattr(ctx, f) is None
                else {k: cut(t, getattr(specs, f)[k])
                      for k, t in getattr(ctx, f).items()})
            for f in ("x", "y")})

    def init(self, model_init: Callable, data) -> RoundState:
        """Fresh training: clears ``rounds_done`` and ``history``; every
        model is drawn from its own generator keyed on ``hp.seed``."""
        self.rounds_done = 0
        self.history = []
        return self.algo.init(self.algo.hp.seed, model_init, data)

    def make_ctx(self, data, o_idx=None, weights=None,
                 active_budget: Optional[int] = None, cohort=None,
                 population: Optional[int] = None) -> BatchCtx:
        return BatchCtx(x=data.x_clients, y=data.y_clients,
                        open_x=data.open_x if self.algo.uses_open else None,
                        o_idx=o_idx, weights=weights, cohort=cohort,
                        active_budget=active_budget, population=population)

    # ----------------------------------------------------------------- run --
    def run(self, state: RoundState, data, rounds: Optional[int] = None,
            weights=None, log_every: int = 1,
            start_round: Optional[int] = None, chunk_rounds: int = 1,
            ctx_plan=None, active_budget: Optional[int] = None,
            cohort=None, population: Optional[int] = None,
            overlap: bool = False, draws=None) -> RoundState:
        """Run ``rounds`` rounds (default ``hp.rounds``) from
        ``start_round`` (default ``rounds_done``, which ``load_state``
        restores).  ``ctx_plan`` is a dict of per-round BatchCtx overrides
        with a leading (rounds,) axis (e.g. ``{"mask": (rounds, K)}``);
        ``draws`` a list of per-round `RoundDraws`.  ``active_budget=m``
        computes only the (at most) m participants of each masked round; a
        ``ctx_plan`` mask must then give every round between 1 and m
        participants.  ``chunk_rounds``/``overlap``: see the module
        docstring; the host hooks ``on_ctx``/``on_round`` force one round
        at a time."""
        hp = self.algo.hp
        if overlap and getattr(self.algo, "round_start", None) is None:
            raise ValueError(
                f"overlap=True needs algorithm {self.algo.name!r} to expose "
                f"round_start/round_finish (the pipelined round halves); "
                f"{type(self.algo).__name__} has no round_start")
        rounds = hp.rounds if rounds is None else rounds
        start = self.rounds_done if start_round is None else start_round
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
            pops = (np.asarray(mask_plan[:rounds].cpu()) > 0).sum(axis=-1)
            lo, hi = int(pops.min()), int(pops.max())
            if lo < 1 or hi > active_budget:
                raise ValueError(
                    f"active_budget={active_budget} needs 1 <= participants "
                    f"<= budget every round; ctx_plan masks have [{lo}, {hi}]")
        run = _Run(self, state, data, weights, log_every, start, ctx_plan,
                   draws, active_budget, cohort, population)
        chunk = max(1, int(chunk_rounds))
        if self.on_round is not None or self.on_ctx is not None:
            chunk = 1
        if chunk > 1:
            if self.eval_fn is not None and log_every < chunk:
                warnings.warn(
                    f"eval_fn snaps every chunk to log_every={log_every} "
                    f"rounds, cutting the requested chunk_rounds={chunk} (each "
                    f"eval needs a host sync); pass log_every=chunk_rounds",
                    stacklevel=2)
            state = self._run_chunked(run, state, rounds, chunk, overlap)
        else:
            if overlap:
                warnings.warn(
                    "overlap=True only pipelines the chunked path; the "
                    "per-round loop (chunk_rounds<=1, or per-round host "
                    "hooks) runs one round at a time, which makes the same "
                    "calls", stacklevel=2)
            state = self._run_loop(run, state, rounds)
        reg = obs.current_registry()
        if reg is not None:
            reg.counter("engine.rounds").inc(rounds)
        return state

    def _run_loop(self, run: "_Run", state, rounds: int):
        for r in range(run.start, run.start + rounds):
            run.load_chunk(r, 1)
            ctx = run.ctx(r)
            if self.on_ctx is not None:
                ctx = self.on_ctx(r, ctx)
            with obs.span("engine.round", "engine", round=r):
                state, m = self.algo.round(state, ctx, r, run.draw(r))
                if self.on_round is not None:
                    state = self.on_round(r, state)
                self.last_metrics = m
                self.rounds_done = r + 1
                if self.on_chunk is not None:
                    self.on_chunk(self.rounds_done, state)
                if (r + 1) % run.log_every == 0:
                    rec = {"round": r + 1,
                           **{k: float(v) for k, v in m.items()
                              if v.ndim == 0}}
                    self._log(rec, state)
        return state

    def _run_chunked(self, run: "_Run", state, rounds: int, chunk: int,
                     overlap: bool):
        r, end, n_chunks = run.start, run.start + rounds, 0
        while r < end:
            k = min(chunk, end - r)
            if self.eval_fn is not None:
                # eval needs the state at every log point: end the chunk
                # exactly on the next log boundary
                k = min(k, (r // run.log_every + 1) * run.log_every - r)
            n_chunks += 1
            run.load_chunk(r, k)
            with obs.span("engine.chunk", "engine", rounds=k, start_round=r,
                          overlap=overlap):
                ms = []
                for rr in range(r, r + k):
                    ctx, d = run.ctx(rr), run.draw(rr)
                    if overlap:
                        inflight = self.algo.round_start(state, ctx, rr, d)
                        state, m = self.algo.round_finish(state, ctx,
                                                          inflight, rr, d)
                    else:
                        state, m = self.algo.round(state, ctx, rr, d)
                    ms.append(m)
                self.last_metrics = ms[-1]
                # one host sync a chunk: the per-round scalars cross together
                names = [key for key, v in ms[-1].items() if v.ndim == 0]
                scalars = (torch.stack([
                    torch.stack([m[key].to(torch.float64) for key in names])
                    for m in ms]).cpu().tolist()
                    if names else [[] for _ in ms])
            for i in range(k):
                if (r + i + 1) % run.log_every == 0:
                    self._log({"round": r + i + 1,
                               **dict(zip(names, scalars[i]))}, state)
            r += k
            self.rounds_done = r
            if self.on_chunk is not None:
                self.on_chunk(self.rounds_done, state)
        reg = obs.current_registry()
        if reg is not None:
            reg.counter("engine.chunks").inc(n_chunks)
        return state

    def _log(self, rec: dict, state) -> None:
        if self.eval_fn is not None:
            with obs.span("engine.eval", "engine"):
                rec.update(self.eval_fn(*self.algo.eval_params(state)))
        self.history.append(rec)

    # -------------------------------------------------------- comm bytes ----
    def _payload_ctx(self, data) -> BatchCtx:
        o_idx = None
        if self.algo.uses_open:
            n_r = min(self.algo.hp.open_batch, leading_dim(data.open_x))
            o_idx = torch.zeros((n_r,), dtype=torch.long, device=self.device)
        return self.make_ctx(data, o_idx=o_idx)

    def measured_leg_bytes(self, state: RoundState, data) -> tuple[int, int]:
        """(uplink bytes per client, downlink broadcast bytes), counted on
        the encoded tensors of one real payload: ``algo.upload_payload``
        computed once (client 0's probabilities on an open batch of the
        round's size, client 0's per-class table, or the server's model)
        and encoded by ``codec.encode_up`` / ``encode_down``.  No gradients
        are kept."""
        with obs.span("wire.measure", "wire", codec=self.codec.name) as sp, \
                torch.no_grad():
            payload = self.algo.upload_payload(state, self._payload_ctx(data))
            up, down = (nbytes(self.codec.encode_up(payload)),
                        nbytes(self.codec.encode_down(payload)))
            sp.set(up_bytes=up, down_bytes=down)
        return up, down

    def measured_round_bytes(self, state: RoundState, data,
                             n_clients: Optional[int] = None) -> int:
        """Per-round wire bytes under ``codec``: K client uploads and one
        multicast broadcast, `comm.CommModel`'s convention."""
        K = leading_dim(data.x_clients) if n_clients is None else n_clients
        up, down = self.measured_leg_bytes(state, data)
        return up * K + down

    # ------------------------------------------------------- checkpointing --
    def save_state(self, path: str, state: RoundState) -> None:
        """The round state's leaves in the reference's order, the algorithm
        tag, ``rounds_done`` and ``history``, in the reference's layout:
        each package reads the other's files.  Over a mesh every rank
        calls it: every sharded leaf is gathered whole, rank 0 writes
        the whole state, and every rank returns once the file is there."""
        leaves = [v for _, v in named_leaves(state)]
        if self.mesh is not None:
            leaves = [gather_leaf(v.contiguous(), sp, self.mesh)
                      for v, sp in zip(leaves, self._state_specs(state))]
        if self.rank == 0:
            tag = np.frombuffer(self.algo.name.encode(), dtype=np.uint8)
            hist = np.frombuffer(json.dumps(self.history,
                                            default=float).encode(),
                                 dtype=np.uint8)
            save_pytree(path, {"algo": tag, "leaves": leaves,
                               "round": np.int64(self.rounds_done),
                               "history": hist})
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()

    def load_state(self, path: str, like: RoundState,
                   shardings=None) -> RoundState:
        """Restore a state written by ``save_state`` (this package's or the
        reference's).  ``like`` (e.g. a fresh ``init``) gives the structure,
        the device and each leaf's name; a wrong leaf count, shape or dtype
        raises, naming the leaf.  ``shardings`` (the state's spec tree,
        ``algo.shardings(mesh, like, ctx)[0]``) keeps this rank's part of
        each leaf on the engine's mesh.  Also restores ``rounds_done`` and
        ``history``, so a later ``run`` resumes where the file left off."""
        keep = None
        if shardings is not None:
            if self.mesh is None:
                raise ValueError("load_state(shardings=) needs the engine's "
                                 "mesh")
            keep = {"leaves": [RankSlice(self.mesh, sp, self.rank)
                               for sp in nodes_at_leaves(shardings, like)]}
        raw = load_pytree(path, keep)
        tag = bytes(raw["algo"].numpy().tobytes()).decode()
        if tag != self.algo.name:
            raise ValueError(f"checkpoint is for {tag!r}, "
                             f"engine runs {self.algo.name!r}")
        n_like = len(named_leaves(like))
        if len(raw["leaves"]) != n_like:
            raise ValueError(
                f"checkpoint {path!r} holds {len(raw['leaves'])} leaves but "
                f"the engine's state has {n_like}: it was saved from a "
                f"different model or config than this {self.algo.name!r} "
                f"state")
        state = with_leaves(like, [v.to(lv.device) for v, (_, lv) in
                                   zip(raw["leaves"], named_leaves(like))])
        assert_tree_compatible(like, state, what=f"checkpoint {path!r}")
        if "round" in raw:
            self.rounds_done = int(raw["round"])
        if "history" in raw:
            self.history = json.loads(
                bytes(raw["history"].numpy().tobytes()).decode())
        return state


class _Run:
    """One ``run`` call's per-round inputs: the round's BatchCtx (the keyed
    open batch, the plan's row) and its injected draws."""

    def __init__(self, eng: FedEngine, state, data, weights, log_every,
                 start, ctx_plan, draws, active_budget, cohort, population):
        self.eng, self.data, self.start = eng, data, start
        self.log_every = log_every
        self.plan, self.draws = ctx_plan, draws
        self.ctx0 = eng.local_ctx(eng.make_ctx(
            data, weights=weights, active_budget=active_budget,
            cohort=cohort, population=population), state)
        algo = eng.algo
        if algo.uses_open:
            n_open = leading_dim(data.open_x)
            self.n_open, self.n_r = n_open, min(algo.hp.open_batch, n_open)

    def load_chunk(self, r0: int, k: int) -> None:
        """Move the plan rows of rounds [r0, r0 + k) to the device at once."""
        if self.plan is not None:
            i = r0 - self.start
            self._r0 = r0
            self._rows = {f: v[i:i + k].to(self.eng.device)
                          for f, v in self.plan.items()}

    def ctx(self, r: int) -> BatchCtx:
        """Round r's BatchCtx (r in the chunk `load_chunk` moved last)."""
        eng, ctx = self.eng, self.ctx0
        d = self.draw(r)
        if d is not None and d.o_idx is not None:
            ctx = dataclasses.replace(ctx, o_idx=d.o_idx.to(eng.device))
        elif eng.algo.uses_open:
            ctx = dataclasses.replace(ctx, o_idx=open_batch(
                eng.algo.hp.seed, r, self.n_open, self.n_r, eng.device))
        if self.plan is not None:
            ctx = dataclasses.replace(ctx, **{
                f: v[r - self._r0] for f, v in self._rows.items()})
        return ctx

    def draw(self, r: int):
        return None if self.draws is None else self.draws[r - self.start]
