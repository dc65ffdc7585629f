"""DS-FL (paper Algorithm 1) on the `FedAlgorithm` surface, in PyTorch
(mirrors ``repro/core/algorithms.py``):

    state          = algo.init(gen, model_init, data)       # -> RoundState
    state, metrics = algo.round(state, ctx, gen, draws)     # one round

States are frozen dataclasses of flat tensor dicts, client leaves stacked
over a leading (K,) axis.  `BatchCtx` carries the round's data; an absent
optional slot is ``None``.

Randomness.  The reference splits each round's key into four legs: r1 for
the update permutations, r2 for the clients' distillation permutations, r3
for ``corrupt`` and r4 for the server's distillation permutations.  Here
one ``torch.Generator`` feeds the legs in that order, and `RoundDraws`
injects any of them as tensors, so a parity test can hand in exactly the
permutations the reference drew.

Not ported yet: the participation-sparse plane (``active_budget``) and
the two-level edge aggregation (``agg_edges > 1``), ROADMAP Queue 1; FD and
FedAvg, ROADMAP Queue 1.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
from torch.func import vmap

from ..device import resolve_device
from ..optim import optimizers as opt_lib
from .aggregation import aggregate, participation_weights, weighted_era, weighted_sa
from .client import LocalSpec, local_distill, local_update, predict_probs
from .losses import entropy, pinned_mean, pinned_sum
from .protocol import DSFLConfig  # noqa: F401  (re-exported as part of the API)

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
    """Global-model state held by the server."""
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
    ``staleness_decay ** stale``."""
    x: Any = None           # (K, I_k, ...) private inputs
    y: Any = None           # (K, I_k) private labels
    open_x: Any = None      # (I_o, ...) the full shared open set
    o_idx: Any = None       # (n,) this round's open-batch indices o_r
    weights: Any = None     # (K,) client dataset sizes (FedAvg Eq. 3)
    mask: Any = None        # (K,) 0/1 participation this round
    stale: Any = None       # (K,) rounds since each client last synced


@dataclass(frozen=True)
class RoundDraws:
    """Injected randomness of one round; a ``None`` field is drawn from the
    round's generator instead."""
    o_idx: Any = None           # (n,) open-batch indices (drawn by the engine)
    update_perms: Any = None    # (K, local_epochs, nb, bs)    leg r1
    distill_perms: Any = None   # (K, distill_epochs, nb, bs)  leg r2
    server_perms: Any = None    # (distill_epochs, nb, bs)     leg r4


def present(slot) -> bool:
    """Whether an optional BatchCtx slot carries a tensor."""
    return slot is not None


def select_clients(mask, new_tree, old_tree):
    """Per-leaf ``where`` over the leading client axis: participants take
    the fresh leaves, absent clients keep their previous state.  Trees are
    dicts of tensors or tuples of them."""
    if isinstance(new_tree, tuple):
        return tuple(select_clients(mask, n, o)
                     for n, o in zip(new_tree, old_tree))
    m = mask.to(torch.bool)
    return {k: torch.where(m.reshape((m.shape[0],) + (1,) * (n.ndim - 1)),
                           n, old_tree[k])
            for k, n in new_tree.items()}


def masked_mean(values, mask):
    """Mean of ``values`` over the mask-1 lanes."""
    return pinned_mean(values, mask.to(F32))


def _stack(trees: list[dict]) -> dict:
    return {k: torch.stack([t[k] for t in trees]) for k in trees[0]}


def _first(tree: dict) -> dict:
    return {k: v[0] for k, v in tree.items()}


def _lift(tree: dict) -> dict:
    """One model's tree as a stack of one client."""
    return {k: v[None] for k, v in tree.items()}


def _draw(draws: Optional[RoundDraws], name: str):
    return None if draws is None else getattr(draws, name)


# ---------------------------------------------------------------- DS-FL ------
@dataclass(frozen=True)
class DSFLAlgorithm:
    """Paper Algorithm 1 (SA / ERA / weighted ERA).

    ``corrupt(probs (K, n, C), xo, gen) -> probs`` optionally injects
    malicious local logits between "2. Prediction" and "4. Aggregation".
    ``agg_weights=None`` with ``aggregation="weighted_era"`` re-estimates
    each client's reliability every round as the inverse mean entropy of its
    uploaded soft labels.  ``use_kernel=True`` routes "4. Aggregation"
    through the CUDA kernels K1/K2 (dense ERA, weighted ERA, weighted SA and
    every masked round).  ``device`` (default: the card) is where the
    engine that drives the algorithm draws and places each round's data."""
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
        if self.agg_edges != 1:
            raise NotImplementedError(
                "agg_edges > 1 (two-level ERA, repro/core/hierarchy.py) is "
                "not ported yet: ROADMAP Queue 1, hierarchy")
        object.__setattr__(self, "device", resolve_device(self.device))

    def _specs(self):
        hp = self.hp
        opt_u = opt_lib.make(hp.optimizer, hp.lr)
        opt_d = opt_lib.make(hp.optimizer, hp.lr_distill)
        spec_u = LocalSpec(self.apply_fn, opt_u, hp.local_epochs, hp.batch_size)
        spec_d = LocalSpec(self.apply_fn, opt_d, hp.distill_epochs,
                           min(hp.batch_size, hp.open_batch))
        return spec_u, spec_d

    def init(self, gen: torch.Generator, model_init: Callable,
             data) -> RoundState:
        """The server model, then K client models, drawn from ``gen``."""
        K = data.x_clients.shape[0]
        wg, sg = model_init(gen)
        inits = [model_init(gen) for _ in range(K)]
        return self.init_from(_stack([p for p, _ in inits]),
                              _stack([s for _, s in inits]), wg, sg)

    def init_from(self, wk, sk, wg, sg) -> RoundState:
        """Build a RoundState around externally initialized models."""
        spec_u, spec_d = self._specs()
        return RoundState(
            clients=ClientState(params=wk, model_state=sk,
                                opt_update=spec_u.opt.init(wk),
                                opt_distill=spec_d.opt.init(wk)),
            server=ServerState(params=wg, model_state=sg,
                               opt_distill=spec_d.opt.init(wg)))

    def _masked_teacher(self, probs, ctx: BatchCtx):
        """"3-5. Upload / Aggregation / Broadcast" of a masked round over the
        full (K, n, C) upload stack.  Absent clients carry exactly zero
        weight."""
        hp = self.hp
        agg_w = self.agg_weights
        if agg_w is None and hp.aggregation == "weighted_era":
            agg_w = 1.0 / (entropy(probs).mean(dim=-1) + 1e-3)
        pw = participation_weights(
            ctx.mask, ctx.stale if present(ctx.stale) else None,
            hp.staleness_decay, base=agg_w)
        global_logit = (
            weighted_sa(probs, pw, use_kernel=self.use_kernel)
            if hp.aggregation == "sa"
            else weighted_era(probs, pw, hp.temperature,
                              use_kernel=self.use_kernel))
        # the unsharpened SA diagnostic over the uploads that happened
        sa_entropy = entropy(weighted_sa(probs, ctx.mask)).mean()
        return pw, global_logit, sa_entropy

    def round(self, state: RoundState, ctx: BatchCtx, gen: torch.Generator,
              draws: Optional[RoundDraws] = None):
        return self.round_finish(state, ctx,
                                 self.round_start(state, ctx, gen, draws),
                                 gen, draws)

    def round_start(self, state: RoundState, ctx: BatchCtx,
                    gen: torch.Generator, draws: Optional[RoundDraws] = None):
        """"1. Update" + "2. Prediction".  Returns the in-flight
        ``(wk, sk, ouk, up_loss, probs)`` that `round_finish` consumes."""
        spec_u, _ = self._specs()
        wk, sk = state.clients.params, state.clients.model_state
        ouk = state.clients.opt_update
        xo = ctx.open_x[ctx.o_idx]

        # 1. Update (every client computes; a where keeps absent ones)
        wk_n, sk_n, ouk_n, up_loss = local_update(
            spec_u, wk, sk, ouk, ctx.x, ctx.y,
            perms=_draw(draws, "update_perms"), gen=gen)
        if present(ctx.mask):
            wk, sk, ouk = select_clients(ctx.mask, (wk_n, sk_n, ouk_n),
                                         (wk, sk, ouk))
        else:
            wk, sk, ouk = wk_n, sk_n, ouk_n

        # 2. Prediction (local probabilities on o_r)
        probs = vmap(lambda w, s: predict_probs(self.apply_fn, w, s, xo))(
            wk, sk)
        if self.corrupt is not None:
            probs = self.corrupt(probs, xo, gen)
        return (wk, sk, ouk, up_loss, probs)

    def round_finish(self, state: RoundState, ctx: BatchCtx, inflight,
                     gen: torch.Generator,
                     draws: Optional[RoundDraws] = None):
        """"3-6'. Upload / Aggregation / Broadcast / Distillation"."""
        hp = self.hp
        _, spec_d = self._specs()
        odk = state.clients.opt_distill
        wg, sg = state.server.params, state.server.model_state
        odg = state.server.opt_distill
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
            global_logit = aggregate(probs, hp.aggregation, hp.temperature,
                                     weights=agg_w, use_kernel=self.use_kernel)
            sa_entropy = entropy(probs.mean(dim=0)).mean()
        g_entropy = entropy(global_logit).mean()

        # 6. Distillation (clients, Eq. 10; absent clients keep their state)
        wk_n, sk_n, odk_n, d_loss = local_distill(
            spec_d, wk, sk, odk, xo, global_logit,
            perms=_draw(draws, "distill_perms"), gen=gen)
        if masked:
            wk, sk, odk = select_clients(ctx.mask, (wk_n, sk_n, odk_n),
                                         (wk, sk, odk))
        else:
            wk, sk, odk = wk_n, sk_n, odk_n

        # 6'. the server's global model (Eq. 11), on its own permutations
        server_perms = _draw(draws, "server_perms")
        wg, sg, odg, gd_loss = local_distill(
            spec_d, _lift(wg), _lift(sg), _lift(odg), xo, global_logit,
            perms=None if server_perms is None else server_perms[None],
            gen=gen)
        wg, sg, odg = _first(wg), _first(sg), _first(odg)

        metrics = {"update_loss": (masked_mean(up_loss, ctx.mask) if masked
                                   else up_loss.mean()),
                   "distill_loss": (masked_mean(d_loss, ctx.mask) if masked
                                    else d_loss.mean()),
                   "server_distill_loss": gd_loss[0],
                   "global_entropy": g_entropy,
                   "sa_entropy": sa_entropy}
        if pw is not None:
            # normalized per-client aggregation weights (non-scalar: kept on
            # `FedEngine.last_metrics`, out of the scalar history)
            metrics["agg_weights"] = pw / torch.clamp(pinned_sum(pw), min=1e-9)
        if masked:
            metrics["participants"] = ctx.mask.to(F32).sum()
        return RoundState(clients=ClientState(wk, sk, ouk, odk),
                          server=ServerState(wg, sg, odg)), metrics

    def upload_payload(self, state: RoundState, ctx: BatchCtx):
        """One client's upload: per-sample probability vectors on o_r."""
        xo = ctx.open_x[ctx.o_idx]
        return predict_probs(self.apply_fn, _first(state.clients.params),
                             _first(state.clients.model_state), xo)

    def eval_params(self, state: RoundState):
        return state.server.params, state.server.model_state

