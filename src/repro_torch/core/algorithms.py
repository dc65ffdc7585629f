"""DS-FL (paper Algorithm 1) and its baselines FD and FedAvg on the
`FedAlgorithm` surface, in PyTorch (mirrors ``repro/core/algorithms.py``):

    state          = algo.init(seed, model_init, data)      # -> RoundState
    state, metrics = algo.round(state, ctx, rnd, draws)     # round rnd

States are frozen dataclasses of flat tensor dicts, client leaves stacked
over a leading (K,) axis.  `BatchCtx` carries the round's data; an absent
optional slot is ``None``.

Randomness is keyed (`core.prng`): every draw of round ``rnd`` is a pure
function of (hp.seed, rnd, leg, global client id).  The reference's four
legs keep their names: "update" for the update permutations, "distill" for
the clients' distillation permutations, "corrupt" for ``corrupt``'s
generator and "server" for the server's distillation permutations; a model
init takes a generator keyed on ("init", id) (the server's on
"init_server").  A lane's global id is ``BatchCtx.cohort[lane]`` on a
cohort slab and the lane index otherwise, so a client draws the same rows
in a dense stack, a sparse gather or any slab.  `RoundDraws` injects any
leg as tensors, so a parity test can hand in exactly the permutations the
reference drew.

The participation-sparse plane: with ``BatchCtx.active_budget = m`` below
the lane count and a mask, a round gathers the m lanes `active_indices`
picks (participants first), draws their rows alone, computes on those
lanes and scatters the results back; absent clients' state and the
aggregation weights come out bitwise as the dense masked round's.  The
participants' leaves do too where the per-client arithmetic does not
depend on the lane count; convolutions may not (cuDNN and oneDNN pick
algorithms per batch), so there they agree to rounding
(`tests/test_torch_sparse.py`).

The cohort plane: with ``BatchCtx.cohort`` (S,) global ids, the client
axis of the data, the mask and the client stack is a slab of S lanes out
of a fleet of ``population`` (`core.cohort`, `sim.runner.CohortRunner`).
Every cross-client sum runs lane after lane (`lanes.lane_sum`), so the
exact-zero lanes of absent clients change no bit wherever they sit and a
slab round equals the dense masked round.

FD and FedAvg draw only the update leg's permutations.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
from torch.func import vmap

from ..device import resolve_device
from ..lanes import lane_sum
from ..optim import optimizers as opt_lib
from . import fd as fd_lib
from . import prng
from .aggregation import aggregate, participation_weights, weighted_era, weighted_sa
from .client import (LocalSpec, local_distill, local_update, perms_for,
                     predict_probs)
from .fedavg import weighted_average
from .hierarchy import hierarchical_weighted_era, hierarchical_weighted_sa
from .losses import entropy
from .protocol import DSFLConfig  # noqa: F401  (re-exported as part of the API)
from .trees import tree_map

F32 = torch.float32


# --------------------------------------------------------------- states ------
@dataclass(frozen=True)
class ClientState:
    """Per-client persistent state, stacked over the leading (K,) axis."""
    params: dict = field(default_factory=dict)
    model_state: dict = field(default_factory=dict)   # BatchNorm running stats
    opt_update: dict = field(default_factory=dict)    # "1. Update" optimizer
    opt_distill: dict = field(default_factory=dict)   # "6. Distillation" optimizer


@dataclass(frozen=True)
class ServerState:
    """Global-model state held by the server (empty for FD)."""
    params: dict = field(default_factory=dict)
    model_state: dict = field(default_factory=dict)
    opt_distill: dict = field(default_factory=dict)


@dataclass(frozen=True)
class RoundState:
    clients: ClientState = ClientState()
    server: ServerState = ServerState()


@dataclass(frozen=True)
class BatchCtx:
    """Per-round data.  ``mask``/``stale`` are the partial-participation
    fields: absent clients (mask 0) neither train nor contribute to the
    aggregate, and stale contributions are discounted by
    ``staleness_decay ** stale``.  ``active_budget`` m below K, with a
    mask, makes the round participation-sparse; the caller guarantees
    ``1 <= popcount(mask) <= m`` (`FedEngine.run` checks its plan)."""
    x: Any = None           # (K, I_k, ...) private inputs
    y: Any = None           # (K, I_k) private labels
    open_x: Any = None      # (I_o, ...) the full shared open set
    o_idx: Any = None       # (n,) this round's open-batch indices o_r
    weights: Any = None     # (K,) client dataset sizes (FedAvg Eq. 3)
    mask: Any = None        # (K,) 0/1 participation this round
    stale: Any = None       # (K,) rounds since each client last synced
    cohort: Any = None      # (S,) global client id of each slab lane
    active_budget: Optional[int] = None   # at most m participants a round
    population: Optional[int] = None      # fleet size K on the cohort plane


@dataclass(frozen=True)
class RoundDraws:
    """Injected randomness of one round, one row per lane; a ``None`` field
    is drawn keyed instead.  FD and FedAvg read ``update_perms`` only."""
    o_idx: Any = None           # (n,) open-batch indices (drawn by the engine)
    update_perms: Any = None    # (K, local_epochs, nb, bs)    leg r1
    distill_perms: Any = None   # (K, distill_epochs, nb, bs)  leg r2
    server_perms: Any = None    # (distill_epochs, nb, bs)     leg r4


def present(slot) -> bool:
    """Whether an optional BatchCtx slot carries a tensor."""
    return slot is not None


def select_clients(mask, new_tree, old_tree):
    """Per-leaf ``where`` over the leading client axis: participants take
    the fresh leaves, absent clients keep their previous state."""
    m = mask.to(torch.bool)
    return tree_map(lambda n, o: torch.where(
        m.reshape((m.shape[0],) + (1,) * (n.ndim - 1)), n, o),
        new_tree, old_tree)


def masked_mean(values, mask):
    """Mean of ``values`` over the mask-1 lanes, both sums lane after lane
    (`lanes.lane_sum`)."""
    m = mask.to(F32)
    return lane_sum(values * m) / torch.clamp(lane_sum(m), min=1.0)


def lane_ids(ctx: BatchCtx):
    """(L,) global client id of each lane: ``ctx.cohort`` on a slab, the
    lane index on a dense stack."""
    if present(ctx.cohort):
        return ctx.cohort
    return torch.arange(ctx.x.shape[0], device=ctx.x.device)


def lane_perms(spec: LocalSpec, n: int, ctx: BatchCtx, injected, seed: int,
               rnd: int, leg: str, idx=None):
    """One leg's (L, epochs, nb, bs) permutations of the round's lanes, or
    of the lanes ``idx`` only: injected rows (one per lane) gathered at
    ``idx``, else drawn for those lanes' global ids alone."""
    ids = lane_ids(ctx)
    if injected is not None:
        p = perms_for(spec, n, ids, injected)
        return p if idx is None else p[idx]
    return perms_for(spec, n, ids if idx is None else ids[idx], seed=seed,
                     rnd=rnd, leg=leg)


def normalized(pw):
    """Per-client aggregation weights over their lane-order total."""
    return pw / torch.clamp(lane_sum(pw), min=1e-9)


# --------------------------------------------- participation-sparse plane ----
def active_indices(mask, budget: int):
    """(K,) mask -> (budget,) client indices: a stable argsort of the 0/1
    activity key puts participants first in ascending client order and
    pads with distinct non-participants, so a scatter back never collides.
    Needs ``budget >= popcount(mask)``."""
    key = (mask <= 0).to(torch.int32)
    return torch.argsort(key, stable=True)[:budget]


def gather_clients(tree, idx):
    """The (m, ...) ``idx`` lanes of every leaf of a (K, ...) client stack."""
    return tree_map(lambda a: a.index_select(0, idx), tree)


def scatter_clients(new_tree, old_tree, idx):
    """The (m, ...) computed lanes written back into the (K, ...) stack at
    ``idx``; every other client keeps its previous state."""
    return tree_map(lambda n, o: o.index_copy(0, idx, n), new_tree, old_tree)


def scatter_zeros(values_m, K: int, idx):
    """(m, ...) per-lane results scattered into a (K, ...) buffer of exact
    zeros: a lane not in ``idx`` stays exactly 0 (False for bool), so a
    reduction that gives it zero weight matches the dense masked one."""
    return torch.zeros((K,) + tuple(values_m.shape[1:]), dtype=values_m.dtype,
                       device=values_m.device).index_copy(0, idx, values_m)


def _stack(trees: list[dict]) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _first(tree: dict) -> dict:
    return {k: v[0] for k, v in tree.items()}


def _lift(tree: dict) -> dict:
    """One model's tree as a stack of one client."""
    return {k: v[None] for k, v in tree.items()}


def _draw(draws: Optional[RoundDraws], name: str):
    return None if draws is None else getattr(draws, name)


def _sparse_ctx(ctx: BatchCtx) -> bool:
    return (present(ctx.mask) and ctx.active_budget is not None
            and ctx.active_budget < ctx.x.shape[0])


def _init_server(seed: int, model_init: Callable, device):
    return model_init(prng.generator(seed, 0, "init_server", 0, device))


def init_stack(seed: int, model_init: Callable, ids, device,
               population: Optional[int] = None):
    """(params, state) stacks of the models of clients ``ids``, each drawn
    from a generator keyed on ("init", id): row g is the same in a dense
    init, a lazy cohort init or any slab.  With ``population``, an id
    outside the fleet raises."""
    ids = torch.as_tensor(ids, dtype=torch.int64)
    if population is not None and int(ids.max()) >= population:
        raise ValueError(f"client id {int(ids.max())} outside a fleet of "
                         f"{population}")
    seeds = prng.keys(seed, 0, "init", ids).reshape(-1)
    inits = [model_init(torch.Generator(device=device).manual_seed(k))
             for k in seeds.tolist()]
    return _stack([p for p, _ in inits]), _stack([s for _, s in inits])


# ---------------------------------------------------------------- DS-FL ------
@dataclass(frozen=True)
class DSFLAlgorithm:
    """Paper Algorithm 1 (SA / ERA / weighted ERA).

    ``corrupt(probs (K, n, C), xo, gen) -> probs`` optionally injects
    malicious local logits between "2. Prediction" and "4. Aggregation";
    ``gen`` is a generator keyed on the round's "corrupt" leg.
    ``agg_weights=None`` with ``aggregation="weighted_era"`` re-estimates
    each client's reliability every round as the inverse mean entropy of its
    uploaded soft labels.  ``use_kernel=True`` routes "4. Aggregation"
    through the CUDA kernels K1/K2 (dense ERA, weighted ERA, weighted SA,
    every masked or sparse round, and each edge's partial of a two-level
    round).  ``agg_edges > 1`` aggregates through the edge -> server tree
    of `core.hierarchy`.  ``device`` (default: the card) is where the
    models are made and where the engine places each round's data."""
    apply_fn: Callable
    hp: DSFLConfig
    corrupt: Optional[Callable] = None
    agg_weights: Optional[torch.Tensor] = None
    use_kernel: bool = False
    agg_edges: int = 1
    device: Any = "cuda"

    name = "dsfl"
    uses_open = True

    def __post_init__(self):
        if self.agg_edges < 1:
            raise ValueError(f"agg_edges must be >= 1, got {self.agg_edges}")
        object.__setattr__(self, "device", resolve_device(self.device))

    def _specs(self):
        hp = self.hp
        opt_u = opt_lib.make(hp.optimizer, hp.lr)
        opt_d = opt_lib.make(hp.optimizer, hp.lr_distill)
        spec_u = LocalSpec(self.apply_fn, opt_u, hp.local_epochs, hp.batch_size)
        spec_d = LocalSpec(self.apply_fn, opt_d, hp.distill_epochs,
                           min(hp.batch_size, hp.open_batch))
        return spec_u, spec_d

    def init(self, seed: int, model_init: Callable, data) -> RoundState:
        """The server model and K client models, each from its own keyed
        generator (`init_stack`)."""
        wg, sg = _init_server(seed, model_init, self.device)
        wk, sk = init_stack(seed, model_init, range(data.x_clients.shape[0]),
                            self.device)
        return self.init_from(wk, sk, wg, sg)

    def init_server(self, seed: int, model_init: Callable) -> RoundState:
        """The cohort plane's starting state: the server model alone (the
        dense `init`'s), client slabs stream in through `init_cohort`."""
        _, spec_d = self._specs()
        wg, sg = _init_server(seed, model_init, self.device)
        return RoundState(server=ServerState(params=wg, model_state=sg,
                                             opt_distill=spec_d.opt.init(wg)))

    def init_cohort(self, seed: int, model_init: Callable, ids,
                    population: int) -> ClientState:
        """Fresh client states of the global ids ``ids`` (one row each):
        row g equals row g of the dense `init`'s stack."""
        spec_u, spec_d = self._specs()
        wk, sk = init_stack(seed, model_init, ids, self.device, population)
        return ClientState(params=wk, model_state=sk,
                           opt_update=spec_u.opt.init(wk),
                           opt_distill=spec_d.opt.init(wk))

    def init_from(self, wk, sk, wg, sg) -> RoundState:
        """Build a RoundState around externally initialized models."""
        spec_u, spec_d = self._specs()
        return RoundState(
            clients=ClientState(params=wk, model_state=sk,
                                opt_update=spec_u.opt.init(wk),
                                opt_distill=spec_d.opt.init(wk)),
            server=ServerState(params=wg, model_state=sg,
                               opt_distill=spec_d.opt.init(wg)))

    def _teacher(self, probs, weights):
        """"4. Aggregation" of a (K, n, C) stack under (K,) weights: flat, or
        through the edge tree when ``agg_edges > 1``."""
        hp = self.hp
        if self.agg_edges > 1:
            if hp.aggregation == "sa":
                return hierarchical_weighted_sa(probs, weights, self.agg_edges,
                                                use_kernel=self.use_kernel)
            return hierarchical_weighted_era(probs, weights, hp.temperature,
                                             self.agg_edges,
                                             use_kernel=self.use_kernel)
        if hp.aggregation == "sa":
            return weighted_sa(probs, weights, use_kernel=self.use_kernel)
        return weighted_era(probs, weights, hp.temperature,
                            use_kernel=self.use_kernel)

    def _masked_teacher(self, probs, ctx: BatchCtx):
        """"3-5. Upload / Aggregation / Broadcast" of a masked round over the
        full (K, n, C) upload stack, shared by the dense masked and the
        sparse rounds (whose absent lanes are exact zeros).  Absent clients
        carry exactly zero weight."""
        hp = self.hp
        agg_w = self.agg_weights
        if agg_w is None and hp.aggregation == "weighted_era":
            agg_w = 1.0 / (entropy(probs).mean(dim=-1) + 1e-3)
        pw = participation_weights(
            ctx.mask, ctx.stale if present(ctx.stale) else None,
            hp.staleness_decay, base=agg_w)
        global_logit = self._teacher(probs, pw)
        # the unsharpened SA diagnostic over the uploads that happened
        sa_entropy = entropy(weighted_sa(probs, ctx.mask)).mean()
        return pw, global_logit, sa_entropy

    def _is_sparse(self, ctx: BatchCtx) -> bool:
        """Whether the round takes the participation-sparse plane.  Not with
        ``corrupt``: it sees the full upload stack, so it keeps the dense
        path.  Both halves of a round ask, so they cannot disagree."""
        return _sparse_ctx(ctx) and self.corrupt is None

    def round(self, state: RoundState, ctx: BatchCtx, rnd: int,
              draws: Optional[RoundDraws] = None):
        """Round ``rnd`` (it keys the round's draws): `round_finish` of
        `round_start`, the calls of the reference's pipelined schedule in
        its order, so the engine's ``overlap=True`` runs this."""
        return self.round_finish(state, ctx,
                                 self.round_start(state, ctx, rnd, draws),
                                 rnd, draws)

    def round_start(self, state: RoundState, ctx: BatchCtx, rnd: int,
                    draws: Optional[RoundDraws] = None):
        """"1. Update" + "2. Prediction".  Returns the in-flight
        ``(wk, sk, ouk, up_loss, probs)`` that `round_finish` consumes
        (m lanes on the sparse plane)."""
        if self._is_sparse(ctx):
            return self._sparse_start(state, ctx, rnd, draws)
        spec_u, _ = self._specs()
        wk, sk = state.clients.params, state.clients.model_state
        ouk = state.clients.opt_update
        xo = ctx.open_x[ctx.o_idx]

        # 1. Update (every client computes; a where keeps absent ones)
        perms = lane_perms(spec_u, ctx.y.shape[1], ctx,
                           _draw(draws, "update_perms"), self.hp.seed, rnd,
                           "update")
        wk_n, sk_n, ouk_n, up_loss = local_update(
            spec_u, wk, sk, ouk, ctx.x, ctx.y, perms)
        if present(ctx.mask):
            wk, sk, ouk = select_clients(ctx.mask, (wk_n, sk_n, ouk_n),
                                         (wk, sk, ouk))
        else:
            wk, sk, ouk = wk_n, sk_n, ouk_n

        # 2. Prediction (local probabilities on o_r)
        probs = vmap(lambda w, s: predict_probs(self.apply_fn, w, s, xo))(
            wk, sk)
        if self.corrupt is not None:
            probs = self.corrupt(probs, xo, prng.generator(
                self.hp.seed, rnd, "corrupt", 0, probs.device))
        return (wk, sk, ouk, up_loss, probs)

    def round_finish(self, state: RoundState, ctx: BatchCtx, inflight,
                     rnd: int, draws: Optional[RoundDraws] = None):
        """"3-6'. Upload / Aggregation / Broadcast / Distillation"."""
        if self._is_sparse(ctx):
            return self._sparse_finish(state, ctx, inflight, rnd, draws)
        hp = self.hp
        _, spec_d = self._specs()
        odk = state.clients.opt_distill
        masked = present(ctx.mask)
        xo = ctx.open_x[ctx.o_idx]
        wk, sk, ouk, up_loss, probs = inflight

        # 3-5. Upload / Aggregation / Broadcast
        if masked:
            pw, global_logit, sa_entropy = self._masked_teacher(probs, ctx)
        else:
            agg_w = self.agg_weights
            if agg_w is None and hp.aggregation == "weighted_era":
                # adaptive reliability: inverse mean entropy of each
                # client's uploaded soft labels, re-estimated every round
                agg_w = 1.0 / (entropy(probs).mean(dim=-1) + 1e-3)
            pw = agg_w
            if self.agg_edges > 1:
                global_logit = self._teacher(
                    probs, torch.ones((probs.shape[0],), dtype=F32,
                                      device=probs.device)
                    if agg_w is None else agg_w)
            else:
                global_logit = aggregate(probs, hp.aggregation,
                                         hp.temperature, weights=agg_w,
                                         use_kernel=self.use_kernel)
            sa_entropy = entropy(probs.mean(dim=0)).mean()

        # 6. Distillation (clients, Eq. 10; absent clients keep their state)
        perms = lane_perms(spec_d, xo.shape[0], ctx,
                           _draw(draws, "distill_perms"), hp.seed, rnd,
                           "distill")
        wk_n, sk_n, odk_n, d_loss = local_distill(
            spec_d, wk, sk, odk, xo, global_logit, perms)
        if masked:
            wk, sk, odk = select_clients(ctx.mask, (wk_n, sk_n, odk_n),
                                         (wk, sk, odk))
        else:
            wk, sk, odk = wk_n, sk_n, odk_n

        server, metrics = self._server_distill(state, xo, global_logit, rnd,
                                               draws)
        metrics.update(
            update_loss=(masked_mean(up_loss, ctx.mask) if masked
                         else up_loss.mean()),
            distill_loss=(masked_mean(d_loss, ctx.mask) if masked
                          else d_loss.mean()),
            sa_entropy=sa_entropy)
        if pw is not None:
            # normalized per-client aggregation weights (non-scalar: kept on
            # `FedEngine.last_metrics`, out of the scalar history)
            metrics["agg_weights"] = normalized(pw)
        if masked:
            metrics["participants"] = ctx.mask.to(F32).sum()
        return RoundState(clients=ClientState(wk, sk, ouk, odk),
                          server=server), metrics

    def _server_distill(self, state: RoundState, xo, global_logit, rnd: int,
                        draws: Optional[RoundDraws]):
        """6'. the server's global model (Eq. 11) on its own permutations
        (the "server" leg, id 0).  Returns the new `ServerState` and the
        round's server metrics."""
        _, spec_d = self._specs()
        srv = state.server
        server_perms = _draw(draws, "server_perms")
        perms = perms_for(
            spec_d, xo.shape[0], torch.zeros((1,), dtype=torch.int64,
                                             device=xo.device),
            None if server_perms is None else server_perms[None],
            seed=self.hp.seed, rnd=rnd, leg="server")
        wg, sg, odg, gd_loss = local_distill(
            spec_d, _lift(srv.params), _lift(srv.model_state),
            _lift(srv.opt_distill), xo, global_logit, perms)
        return (ServerState(_first(wg), _first(sg), _first(odg)),
                {"server_distill_loss": gd_loss[0],
                 "global_entropy": entropy(global_logit).mean()})

    def _sparse_start(self, state: RoundState, ctx: BatchCtx, rnd: int,
                      draws: Optional[RoundDraws]):
        """The sparse plane's start leg: gather the m active lanes of the
        client stack and their data, draw those lanes' permutations alone,
        then "1. Update" and "2. Prediction" on those lanes.  Returns the
        m-lane in-flight buffers."""
        spec_u, _ = self._specs()
        c = state.clients
        xo = ctx.open_x[ctx.o_idx]
        idx = active_indices(ctx.mask, ctx.active_budget)
        mask_m = ctx.mask[idx]
        x_m, y_m = gather_clients((ctx.x, ctx.y), idx)
        wk_m, sk_m, ouk_m = gather_clients(
            (c.params, c.model_state, c.opt_update), idx)
        perms = lane_perms(spec_u, ctx.y.shape[1], ctx,
                           _draw(draws, "update_perms"), self.hp.seed, rnd,
                           "update", idx)

        # 1. Update on the gathered lanes (padding lanes keep their state)
        wk_n, sk_n, ouk_n, up_loss = local_update(
            spec_u, wk_m, sk_m, ouk_m, x_m, y_m, perms=perms)
        wk_m, sk_m, ouk_m = select_clients(mask_m, (wk_n, sk_n, ouk_n),
                                           (wk_m, sk_m, ouk_m))

        # 2. Prediction on the active lanes (the finish leg scatters them
        # into exact zeros, so the masked aggregation sees its (K, n, C))
        probs_m = vmap(lambda w, s: predict_probs(self.apply_fn, w, s, xo))(
            wk_m, sk_m)
        return (wk_m, sk_m, ouk_m, up_loss, probs_m)

    def _sparse_finish(self, state: RoundState, ctx: BatchCtx, inflight,
                       rnd: int, draws: Optional[RoundDraws]):
        """The sparse plane's finish leg: the dense masked aggregation on the
        uploads scattered into exact zeros, distillation of the gathered
        lanes, and the results scattered back into the (K, ...) stacks."""
        _, spec_d = self._specs()
        c = state.clients
        K = ctx.x.shape[0]
        xo = ctx.open_x[ctx.o_idx]
        idx = active_indices(ctx.mask, ctx.active_budget)
        mask_m = ctx.mask[idx]
        odk_m = gather_clients(c.opt_distill, idx)
        wk_m, sk_m, ouk_m, up_loss, probs_m = inflight

        # 3-5. the dense masked aggregation, verbatim
        pw, global_logit, sa_entropy = self._masked_teacher(
            scatter_zeros(probs_m, K, idx), ctx)

        # 6. Distillation (clients) on the gathered lanes
        perms = lane_perms(spec_d, xo.shape[0], ctx,
                           _draw(draws, "distill_perms"), self.hp.seed, rnd,
                           "distill", idx)
        wk_n, sk_n, odk_n, d_loss = local_distill(
            spec_d, wk_m, sk_m, odk_m, xo, global_logit, perms=perms)
        wk_m, sk_m, odk_m = select_clients(mask_m, (wk_n, sk_n, odk_n),
                                           (wk_m, sk_m, odk_m))

        server, metrics = self._server_distill(state, xo, global_logit, rnd,
                                               draws)
        clients = ClientState(*scatter_clients(
            (wk_m, sk_m, ouk_m, odk_m),
            (c.params, c.model_state, c.opt_update, c.opt_distill), idx))
        metrics.update(
            update_loss=masked_mean(scatter_zeros(up_loss, K, idx), ctx.mask),
            distill_loss=masked_mean(scatter_zeros(d_loss, K, idx), ctx.mask),
            sa_entropy=sa_entropy,
            agg_weights=normalized(pw),
            participants=ctx.mask.to(F32).sum())
        return RoundState(clients=clients, server=server), metrics

    def upload_payload(self, state: RoundState, ctx: BatchCtx):
        """One client's upload: per-sample probability vectors on o_r."""
        xo = ctx.open_x[ctx.o_idx]
        return predict_probs(self.apply_fn, _first(state.clients.params),
                             _first(state.clients.model_state), xo)

    def eval_params(self, state: RoundState):
        return state.server.params, state.server.model_state


# ------------------------------------------------------------------- FD ------
@dataclass(frozen=True)
class FDConfig:
    rounds: int = 30
    local_epochs: int = 5
    batch_size: int = 100
    lr: float = 0.1
    optimizer: str = "sgd"
    gamma: float = 1.0          # Eq. 7 distill regularizer weight
    n_classes: int = 10
    seed: int = 0


@dataclass(frozen=True)
class FDAlgorithm:
    """Federated Distillation benchmark (paper §2.2).  Each round every
    client uploads its per-class mean probabilities (Eq. 4); the Eq. 5 mean
    over the classes' owners, debiased per client (Eq. 6), is the soft
    target of the next local update (Eq. 7).  There is no server model."""
    apply_fn: Callable
    hp: FDConfig
    device: Any = "cuda"

    name = "fd"
    uses_open = False

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _spec(self):
        hp = self.hp
        return LocalSpec(self.apply_fn, opt_lib.make(hp.optimizer, hp.lr),
                         hp.local_epochs, hp.batch_size)

    def init(self, seed: int, model_init: Callable, data) -> RoundState:
        """K client models, each from its own keyed generator."""
        return self.init_from(*init_stack(seed, model_init,
                                          range(data.x_clients.shape[0]),
                                          self.device))

    def init_server(self, seed: int, model_init: Callable) -> RoundState:
        """FD has no server model: the cohort plane's state starts empty."""
        return RoundState()

    def init_cohort(self, seed: int, model_init: Callable, ids,
                    population: int) -> ClientState:
        """Fresh client states of the global ids ``ids`` (rows of the dense
        `init`'s stack)."""
        wk, sk = init_stack(seed, model_init, ids, self.device, population)
        return ClientState(params=wk, model_state=sk,
                           opt_update=self._spec().opt.init(wk))

    def init_from(self, wk, sk) -> RoundState:
        return RoundState(clients=ClientState(
            params=wk, model_state=sk, opt_update=self._spec().opt.init(wk)))

    def _tables(self, wk, sk, x, y):
        """Eq. 4 of every lane: (tk (L, C, C), owns (L, C))."""
        C = self.hp.n_classes
        return vmap(lambda w, s, xk, yk: fd_lib.per_label_logits(
            self.apply_fn, w, s, xk, yk, C))(wk, sk, x, y)

    def _update(self, lanes, x, y, tk, tg, n_own, perms):
        """Eq. 6-7 on the lanes ``(params, state, opt_state)``."""
        tgt = vmap(lambda tkk, yk: fd_lib.distill_targets(tg, tkk, n_own, yk)
                   )(tk, y)
        return local_update(self._spec(), *lanes, x, y, perms=perms,
                            distill_extra=tgt, gamma=self.hp.gamma)

    def round(self, state: RoundState, ctx: BatchCtx, rnd: int,
              draws: Optional[RoundDraws] = None):
        c = state.clients
        lanes = (c.params, c.model_state, c.opt_update)
        n = ctx.y.shape[1]
        injected = _draw(draws, "update_perms")
        masked = present(ctx.mask)
        if _sparse_ctx(ctx):
            idx = active_indices(ctx.mask, ctx.active_budget)
            return self._sparse_round(lanes, ctx, idx, lane_perms(
                self._spec(), n, ctx, injected, self.hp.seed, rnd, "update",
                idx))
        perms = lane_perms(self._spec(), n, ctx, injected, self.hp.seed, rnd,
                           "update")
        tk, owns = self._tables(c.params, c.model_state, ctx.x, ctx.y)
        if masked:
            # absent clients' per-class tables leave the Eq. 5 mean entirely
            owns = owns & ctx.mask.to(torch.bool)[:, None]
        tg, n_own = fd_lib.aggregate_fd(tk, owns)
        *new, losses = self._update(lanes, ctx.x, ctx.y, tk, tg, n_own, perms)
        if masked:
            new = select_clients(ctx.mask, tuple(new), lanes)
        metrics = {"update_loss": (masked_mean(losses, ctx.mask) if masked
                                   else losses.mean()),
                   "global_logit": tg}        # (C, C), for Fig. 2 analysis
        return RoundState(clients=ClientState(*new)), metrics

    def _sparse_round(self, lanes, ctx: BatchCtx, idx, perms_m):
        """Tables and the Eq. 7 update on the <= m gathered lanes ``idx``
        only; the Eq. 5 mean sees scattered zero tables whose ``owns`` are
        False, exactly the lanes the dense masked round gives zero
        weight."""
        K = ctx.x.shape[0]
        mask_m = ctx.mask[idx]
        x_m, y_m = gather_clients((ctx.x, ctx.y), idx)
        lanes_m = gather_clients(lanes, idx)
        tk_m, owns_m = self._tables(lanes_m[0], lanes_m[1], x_m, y_m)
        owns_m = owns_m & mask_m.to(torch.bool)[:, None]
        tg, n_own = fd_lib.aggregate_fd(scatter_zeros(tk_m, K, idx),
                                        scatter_zeros(owns_m, K, idx))
        *new, losses = self._update(lanes_m, x_m, y_m, tk_m, tg, n_own,
                                    perms_m)
        new = scatter_clients(select_clients(mask_m, tuple(new), lanes_m),
                              lanes, idx)
        metrics = {"update_loss": masked_mean(scatter_zeros(losses, K, idx),
                                              ctx.mask),
                   "global_logit": tg}
        return RoundState(clients=ClientState(*new)), metrics

    def upload_payload(self, state: RoundState, ctx: BatchCtx):
        """One client's upload: its per-class mean probability table (C, C)."""
        t, _ = fd_lib.per_label_logits(
            self.apply_fn, _first(state.clients.params),
            _first(state.clients.model_state), ctx.x[0], ctx.y[0],
            self.hp.n_classes)
        return t

    def eval_params(self, state: RoundState):
        # no server model: score the mean client model
        mean = lambda t: {k: v.mean(dim=0) for k, v in t.items()}
        return mean(state.clients.params), mean(state.clients.model_state)


# --------------------------------------------------------------- FedAvg ------
@dataclass(frozen=True)
class FedAvgConfig:
    rounds: int = 30
    local_epochs: int = 5
    batch_size: int = 100
    lr: float = 0.1
    optimizer: str = "sgd"
    staleness_decay: float = 0.5    # async: weight factor per round of lag
    seed: int = 0


@dataclass(frozen=True)
class FedAvgAlgorithm:
    """FedAvg benchmark (paper §2.1).  Client state is ephemeral: every
    round each client starts from the server's model with a fresh optimizer
    state; only the server model persists."""
    apply_fn: Callable
    hp: FedAvgConfig
    device: Any = "cuda"

    name = "fedavg"
    uses_open = False

    def __post_init__(self):
        object.__setattr__(self, "device", resolve_device(self.device))

    def _spec(self):
        hp = self.hp
        return LocalSpec(self.apply_fn, opt_lib.make(hp.optimizer, hp.lr),
                         hp.local_epochs, hp.batch_size)

    def init(self, seed: int, model_init: Callable, data) -> RoundState:
        """The server model from the "init_server" key (``data`` unused)."""
        return self.init_from(*_init_server(seed, model_init, self.device))

    def init_from(self, w0, s0) -> RoundState:
        return RoundState(server=ServerState(params=w0, model_state=s0))

    def round(self, state: RoundState, ctx: BatchCtx, rnd: int,
              draws: Optional[RoundDraws] = None):
        spec = self._spec()
        K, n = ctx.y.shape[:2]
        masked = present(ctx.mask)
        injected = _draw(draws, "update_perms")

        def train(x, y, perms):
            # the server's model broadcast to every lane as a stride-0 view
            L = x.shape[0]
            w0, s0 = (tree_map(lambda a: a.expand((L,) + a.shape), t)
                      for t in (state.server.params, state.server.model_state))
            return local_update(spec, w0, s0, spec.opt.init(w0), x, y,
                                perms=perms)

        if _sparse_ctx(ctx):
            # only the <= m active lanes train; their results scatter into
            # exact zeros, which the Eq. 3 average gives zero weight anyway
            idx = active_indices(ctx.mask, ctx.active_budget)
            x_m, y_m = gather_clients((ctx.x, ctx.y), idx)
            perms = lane_perms(spec, n, ctx, injected, self.hp.seed, rnd,
                               "update", idx)
            wk, sk, _, losses = tree_map(lambda a: scatter_zeros(a, K, idx),
                                         train(x_m, y_m, perms))
        else:
            wk, sk, _, losses = train(ctx.x, ctx.y, lane_perms(
                spec, n, ctx, injected, self.hp.seed, rnd, "update"))
        weights = (torch.ones((K,), dtype=F32, device=ctx.x.device)
                   if ctx.weights is None else ctx.weights)
        if masked:
            # absent clients carry exactly zero weight in the Eq. 3 average;
            # stale contributions are discounted FedAsync-style
            weights = participation_weights(
                ctx.mask, ctx.stale if present(ctx.stale) else None,
                self.hp.staleness_decay, base=weights)
        metrics = {"update_loss": (masked_mean(losses, ctx.mask) if masked
                                   else losses.mean())}
        if masked:
            metrics["participants"] = ctx.mask.to(F32).sum()
        return RoundState(server=ServerState(weighted_average(wk, weights),
                                             weighted_average(sk, weights))
                          ), metrics

    def upload_payload(self, state: RoundState, ctx: BatchCtx):
        """One client's upload: the full parameter vector (+ model state)."""
        return {"params": state.server.params,
                "model_state": state.server.model_state}

    def eval_params(self, state: RoundState):
        return state.server.params, state.server.model_state
