"""LLM-scale DS-FL and FedAvg on the `FedAlgorithm` surface (mirrors
``repro/core/llm_algorithms.py``).

`LLMDSFLAlgorithm` wraps `llm_dsfl.dsfl_round_step` (and
`LLMFedAvgAlgorithm` its `fedavg_round_step` twin) behind the surface the
small-net algorithms have, so the LLM path shares `FedEngine` and the
simulator's runners: a `RoundState` holding the client-stacked parameters
(``clients.params``, leaves (K, ...)), a `BatchCtx` carrying the private
token stacks and the shared open set (sub-sampled per round through
``o_idx``), msgpack checkpoints in the reference's layout and measured wire
bytes.  The rounds draw nothing: ``rnd`` and ``draws`` are accepted and
unused, and a model init takes a generator keyed on ("init", client id).

Each algorithm takes an optional ``mesh`` (a ``("pod", "data", "model")``
``DeviceMesh``, `launch.mesh`): the client axis then lies on the "pod"
ranks, each holding its clients' lanes (`core.llm_dsfl`), and ``init``
makes only those (client k's model is keyed on ("init", k) wherever it
is made, so rank r's lanes are the one-process stack's).  Where the mesh
splits "data" or "model" (every family; `launch.tp`), each lane holds
`sharding.local_slice` of its client's leaves, the rounds run under the
plan, and each data rank takes its share of the open batch.
``shardings(mesh, state, ctx)`` gives the reference's spec trees
(`launch.sharding`, on the full shapes whatever a rank holds): parameters
("pod", <rules>), private batches ("pod", "data", ...), the open set
data-sharded, indices and the sim's (K,) fields replicated; `FedEngine`
cuts each rank's private data and its part of a loaded state with them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..device import resolve_device
from ..launch import tp
from ..launch.collectives import pod_group
from ..models.base import ModelConfig
from ..models.shardctx import active_plan
from . import prng
from .aggregation import participation_weights
from .algorithms import BatchCtx, ClientState, RoundState, present
from .llm_dsfl import (LLMDsflHP, dsfl_exchange, dsfl_round_finish,
                       dsfl_round_step, fedavg_round_step, pod_reduce,
                       predict_open_probs)
from .trees import leading_dim

F32 = torch.float32


def _participation(ctx: BatchCtx, decay: float):
    """(K,) aggregation weights from the sim's mask/stale ctx fields, or
    None for the full-participation path."""
    if not present(ctx.mask):
        return None
    return participation_weights(
        ctx.mask, ctx.stale if present(ctx.stale) else None, decay)


def _take_open(open_x: dict, o_idx) -> dict:
    """This round's open batch o_r out of the full shared open set."""
    return {k: v.index_select(0, o_idx) for k, v in open_x.items()}


def _first_client(tree: dict) -> dict:
    return {k: v[0] for k, v in tree.items()}


def _mean_clients(tree: dict, pod=None) -> dict:
    """The mean client model; over ``pod``, each rank's f32 lane sums
    all-reduced and divided by K."""
    if pod is None:
        return {k: v.to(F32).mean(dim=0).to(v.dtype) for k, v in tree.items()}
    K = leading_dim(tree) * pod.size
    return pod_reduce(((k, v.to(F32).sum(dim=0), v.dtype, K)
                       for k, v in tree.items()), pod)


def stack_init(seed: int, model_init: Callable, K: int, device,
               first: int = 0, keep: Callable | None = None) -> dict:
    """Client-stacked parameters (leaves (K, ...)) of clients first, ...,
    first + K - 1: client k's model from a generator keyed on ("init", k),
    written into the stack one client at a time (the peak holds the stack
    and one model); ``keep(model)`` (e.g. a rank's slices) is what is
    written."""
    seeds = prng.keys(seed, 0, "init",
                      torch.arange(first, first + K)).reshape(-1).tolist()
    out = None
    for k, s in enumerate(seeds):
        p = model_init(torch.Generator(device=device).manual_seed(s))
        if keep is not None:
            p = keep(p)
        if out is None:
            out = {n: torch.empty((K,) + tuple(v.shape), dtype=v.dtype,
                                  device=v.device) for n, v in p.items()}
        for n, v in p.items():
            out[n][k].copy_(v)
        del p
    return out


def _state(stacked: dict) -> RoundState:
    return RoundState(clients=ClientState(params=stacked))


def _mesh_setup(algo) -> None:
    """Resolve the device, the mesh's pod group and its `launch.tp` plan
    (None without a mesh, or where "data" and "model" have one rank) on a
    frozen algorithm."""
    object.__setattr__(algo, "device", resolve_device(algo.device))
    mesh = algo.mesh
    # the plan first: a family it refuses is refused before any group
    object.__setattr__(algo, "plan",
                       None if mesh is None else tp.plan_for(algo.cfg, mesh))
    object.__setattr__(algo, "pod", None if mesh is None else pod_group(mesh))


def _open(algo, ctx: BatchCtx) -> dict:
    """This round's open batch, this data rank's share of it under a
    plan."""
    batch = _take_open(ctx.open_x, ctx.o_idx)
    return batch if algo.plan is None else algo.plan.data_rows(batch)


def _init(algo, seed: int, model_init: Callable, data) -> RoundState:
    """This rank's lanes of the client stack (all of it without a mesh)."""
    K = leading_dim(data.x_clients)
    if algo.pod is None:
        return _state(stack_init(seed, model_init, K, algo.device))
    P = algo.pod.size
    if K % P:
        raise ValueError(f"{K} clients do not split over {P} pod ranks")
    n = K // P
    keep = None if algo.plan is None else algo.plan.slices
    return _state(stack_init(seed, model_init, n, algo.device,
                             first=algo.pod.rank * n, keep=keep))


def _shardings(cfg: ModelConfig, mesh, state: RoundState, ctx: BatchCtx,
               with_open: bool):
    """(state, ctx) spec trees (`launch.sharding`): parameters ("pod",
    <TP/FSDP rules>), private batches ("pod", "data", ...), the open set
    data-sharded, ``o_idx`` and the sim's (K,) fields replicated; on a mesh
    without "pod" the client axis is replicated.  Fields the ctx does not
    carry stay None."""
    from ..launch.mesh import axis_sizes
    from ..launch.sharding import batch_specs, model_shapes, param_specs
    client_axis = "pod" if "pod" in axis_sizes(mesh) else None
    rep = lambda t: None if t is None else (None,) * t.ndim
    # the rules read the full shapes: a rank's leaves may be slices
    full = model_shapes(cfg, lead=(1,))
    st = _state(param_specs(cfg, {k: full[k] for k in state.clients.params},
                            mesh, client_axis=client_axis))
    return st, BatchCtx(
        x=(batch_specs(ctx.x, mesh, client_axis=client_axis)
           if ctx.x is not None else None),
        open_x=(batch_specs(ctx.open_x, mesh)
                if with_open and ctx.open_x is not None else None),
        o_idx=rep(ctx.o_idx) if with_open else None,
        mask=rep(ctx.mask), stale=rep(ctx.stale),
        active_budget=ctx.active_budget)


@dataclass(frozen=True)
class LLMDSFLAlgorithm:
    """DS-FL at LLM scale: the round's exchange is the open-batch
    distributions (top-k pairs under ``hp.topk``); ``hp.use_kernel`` puts
    the prediction on K5, the teacher on K1/K2 and the KD term on K3/K4.
    ``device`` (default: the card) is where the models are made; ``mesh``
    puts the clients on its "pod" ranks."""
    cfg: ModelConfig
    hp: LLMDsflHP
    device: Any = "cuda"
    mesh: Any = None

    name = "llm_dsfl"
    uses_open = True

    def __post_init__(self):
        _mesh_setup(self)

    def init(self, seed: int, model_init: Callable, data) -> RoundState:
        return _init(self, seed, model_init, data)

    def init_from(self, stacked_params: dict) -> RoundState:
        """A RoundState around externally made client-stacked params."""
        return _state(stacked_params)

    def _kw(self, ctx: BatchCtx) -> dict:
        return dict(weights=_participation(ctx, self.hp.staleness_decay),
                    mask=ctx.mask if present(ctx.mask) else None,
                    active_budget=ctx.active_budget)

    def round(self, state: RoundState, ctx: BatchCtx, rnd: int, draws=None):
        with active_plan(self.plan):
            new, loss = dsfl_round_step(
                self.cfg, state.clients.params, ctx.x, _open(self, ctx),
                self.hp, **self._kw(ctx), pod=self.pod)
        return _state(new), {"loss": loss}

    # round == round_finish(state, ctx, round_start(state, ctx, ...), ...):
    # the same calls in the same order, split at the wire boundary
    def round_start(self, state: RoundState, ctx: BatchCtx, rnd: int,
                    draws=None):
        """The wire leg: open-batch prediction and the (compressed)
        uploads.  Returns the exchange buffers; over a mesh their gathers
        are issued and left in flight."""
        with active_plan(self.plan):
            return dsfl_exchange(self.cfg, state.clients.params,
                                 _open(self, ctx), self.hp, **self._kw(ctx),
                                 pod=self.pod, async_op=True)

    def round_finish(self, state: RoundState, ctx: BatchCtx, inflight,
                     rnd: int, draws=None):
        """The compute leg: the teacher and the hybrid CE+KD client step."""
        with active_plan(self.plan):
            new, loss = dsfl_round_finish(
                self.cfg, state.clients.params, ctx.x, _open(self, ctx),
                inflight, self.hp, **self._kw(ctx), pod=self.pod)
        return _state(new), {"loss": loss}

    def upload_payload(self, state: RoundState, ctx: BatchCtx):
        """One client's upload: its per-token class distributions on o_r,
        (|o_r|, S, V) bf16, the tensor the wire codec encodes (whole
        rows on every rank under a plan)."""
        with active_plan(self.plan):
            return predict_open_probs(
                self.cfg, _first_client(state.clients.params),
                _take_open(ctx.open_x, ctx.o_idx), self.hp.use_kernel)

    def eval_params(self, state: RoundState):
        # no server model at LLM scale: score the mean client model (a
        # rank's slices of it under a plan)
        return _mean_clients(state.clients.params, self.pod), {}

    def shardings(self, mesh, state: RoundState, ctx: BatchCtx):
        return _shardings(self.cfg, mesh, state, ctx, with_open=True)


@dataclass(frozen=True)
class LLMFedAvgHP:
    lr: float = 1e-4
    staleness_decay: float = 0.5    # async sim: weight factor per round of lag
    rounds: int = 10
    seed: int = 0


@dataclass(frozen=True)
class LLMFedAvgAlgorithm:
    """FedAvg at LLM scale: local SGD, then the parameter mean, whose bytes
    a round equal K + 1 copies of the model; over a mesh, the all-reduce
    of the parameters on its "pod" ranks."""
    cfg: ModelConfig
    hp: LLMFedAvgHP
    device: Any = "cuda"
    mesh: Any = None

    name = "llm_fedavg"
    uses_open = False

    def __post_init__(self):
        _mesh_setup(self)

    def init(self, seed: int, model_init: Callable, data) -> RoundState:
        return _init(self, seed, model_init, data)

    def init_from(self, stacked_params: dict) -> RoundState:
        return _state(stacked_params)

    def round(self, state: RoundState, ctx: BatchCtx, rnd: int, draws=None):
        with active_plan(self.plan):
            new, loss = fedavg_round_step(
                self.cfg, state.clients.params, ctx.x, self.hp.lr,
                weights=_participation(ctx, self.hp.staleness_decay),
                mask=ctx.mask if present(ctx.mask) else None,
                active_budget=ctx.active_budget, pod=self.pod)
        return _state(new), {"loss": loss}

    def upload_payload(self, state: RoundState, ctx: BatchCtx):
        """One client's upload: its full parameters (gathered whole from
        the ranks' slices under a plan)."""
        one = _first_client(state.clients.params)
        return one if self.plan is None else self.plan.whole(one)

    def eval_params(self, state: RoundState):
        # the round's broadcast synced the clients: any one of them (a
        # rank's slices of it under a plan)
        return _first_client(state.clients.params), {}

    def shardings(self, mesh, state: RoundState, ctx: BatchCtx):
        return _shardings(self.cfg, mesh, state, ctx, with_open=False)
