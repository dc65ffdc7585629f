"""DS-FL at LLM scale (mirrors ``repro/core/llm_dsfl.py``): K clients, each
a full language model, exchange per-token class distributions on a shared
open batch; the round's step is the hybrid CE + KD local step.

The reference vmaps the clients over a pod-sharded client axis.  Here the
client-stacked parameters keep its layout (every leaf (K, ...), flat
``/``-joined names) but the clients run one after another, lane after
lane: a round holds one client's gradients at a time instead of K.  Each
step writes its client's new parameters straight into the round's fresh
(K, ...) stack.  Since every lane runs the same per-client operations
whatever the lane count, the participation-sparse round is bitwise the
dense weighted one (`tests/test_torch_llm_dsfl.py`).

Training runs the model's differentiable SSD route (`models.ssm
._chunk_local`, the reference's default), each block recomputed in the
backward; a client's block leaves become one autograd leaf a block
(`_slots`).  With
``hp.use_kernel`` the open-batch prediction runs under ``torch.no_grad()``
through K5, the teacher through K1 (``era``) or K2 (``weighted_era``,
``weighted_sa`` and each edge of the two-level tree) on the (K, B*S, V)
view of the upload stack (exact: both kernels work row by row), and the KD
term through K3 (forward) and K4 (its gradient).

The reference's densify of the top-k uploads (an einsum against a one-hot
of size (K, B, S, k, V)) is a ``scatter`` here: top-k indices are distinct
per token, so the values are the same.

**The client axis over ranks.**  Given ``pod`` (a `launch.collectives
.AxisGroup`: the "pod" axis of a ``("pod", "data", "model")`` mesh of P
ranks), the stack holds this rank's lanes only, clients [r*n, (r+1)*n) of
K = P*n, and every collective of a round is explicit on the pod group:

  * dense: the rank predicts its lanes and all-gathers the (K, B, S, V)
    upload stack in client order (K*B*S*V*2 bytes a rank); K1 or K2 then
    runs unchanged on it, so the teacher is bitwise the one-process one.
    The reference all-reduces the mean through GSPMD instead (deviation:
    an all-gather of K uploads, which lets the unchanged kernels run);
  * top-k: the (values f32, indices int32) pairs, K*B*S*k*8 bytes, then
    the densify runs locally (the reference's ``shard_map`` all-gather);
  * participation-sparse: a rank predicts and trains only its lanes among
    the round's active ones; its other lanes upload exact zeros and keep
    their parameters, so the gathered stack is the one-process
    ``scatter_zeros`` stack, bitwise;
  * FedAvg: the f32 parameter terms all-reduced (the reference's
    collective), then divided by K (or weighted); bitwise the lane path
    for one lane a rank at P = 2, the reduction order of the backend's
    all-reduce beyond;
  * the round's (K,) losses all-gathered (4*K bytes), so every rank
    reports the one-process loss.

``async_op=True`` issues the exchange's gather and returns `Pending`
buffers; the finish leg waits on them only once the first client's
private-data CE has run (its forward never reads the teacher).  Once its
uploads are in flight a rank reads no other rank's parameters.

**"model" and "data" (every family).**  Under a `launch.tp` plan each
lane holds the rank's slices of its client's leaves and the models run
Megatron's collectives.  The round gathers a pass's logits over "model"
(`shardctx.gather_vocab`) before the CE, the KD term (K3/K4 on whole rows) and
the prediction's softmax, so every rank of a "model" group uploads the
same distributions and K1/K2 run on whole rows after the "pod" gather.
Each data rank's loss is its share of the mean (`launch.tp.TPPlan.loss_share`,
the losses summed over "data" at the round's end); its batches are its
rows of every input, a VLM's patches and an encoder's frames with the
tokens.  FedAvg all-reduces
each rank's shards over "pod" only: shards are never gathered.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..lanes import weighted_lane_sum
from ..launch.collectives import (Pending, all_gather_clients,
                                  all_gather_clients_async,
                                  all_reduce_sum_async)
from ..models.api import model_logits
from ..models.base import ModelConfig
from ..models.shardctx import constrain, current_plan, gather_vocab
from .aggregation import era, sa, topk_compress, weighted_era, weighted_sa
from .algorithms import active_indices, masked_mean, scatter_zeros
from .hierarchy import hierarchical_weighted_era, hierarchical_weighted_sa
from .losses import distill_xent, pinned_sum, topk_distill_xent, xent_int_labels

F32, BF16 = torch.float32, torch.bfloat16


@dataclass(frozen=True)
class LLMDsflHP:
    lr: float = 1e-4
    gamma: float = 1.0              # weight of the distillation term
    temperature: float = 0.1        # ERA
    aggregation: str = "era"        # sa | era
    agg_edges: int = 1              # two-level ERA tree width (core.hierarchy)
    aux_weight: float = 0.01        # MoE load-balance loss
    topk: Optional[int] = None      # sparsified logit exchange (beyond paper)
    microbatches: int = 1           # gradient accumulation (activation peak /m)
    staleness_decay: float = 0.5    # async sim: weight factor per round of lag
    # the kernels: K5 for the prediction leg, K1/K2 for the teacher, K3/K4
    # for the KD term (the option the reference's distill_xent and era have)
    use_kernel: bool = False
    # engine-facing fields (`FedEngine` reads rounds/seed/open_batch; the
    # round-step functions ignore them)
    rounds: int = 10
    seed: int = 0
    open_batch: int = 8             # |o_r| in sequences per round


# ------------------------------------------------------ client stacks -------
def n_clients(stacked: dict) -> int:
    return next(iter(stacked.values())).shape[0]


def client(stacked: dict, k: int) -> dict:
    """Client k's parameters: views of lane k of every leaf."""
    return {n: v[k] for n, v in stacked.items()}


def _slots(params: dict):
    """(name, block, tensor) for each autograd leaf of one model: a block
    leaf (n_blocks, ...) gives one a block (``block`` its index), so the
    backward writes each block's gradient once instead of scattering it
    into a zeroed full-stack buffer once a block; any other leaf gives one
    (``block`` None).  `_leaves` and `_apply_sgd` walk them in this order."""
    for n, v in params.items():
        if n.startswith("blocks/"):
            for b in range(v.shape[0]):
                yield n, b, v[b]
        else:
            yield n, None, v


def _leaves(params: dict):
    """One model's parameters as fresh autograd leaves sharing their
    storage: (``params`` with each block leaf the list of its blocks'
    leaves, which the model indexes as it does the stack; the leaves in
    `_slots` order)."""
    tree, flat = {}, []
    for n, b, v in _slots(params):
        leaf = v.detach().requires_grad_()
        flat.append(leaf)
        if b is None:
            tree[n] = leaf
        else:
            tree.setdefault(n, []).append(leaf)
    return tree, flat


def _apply_sgd(params: dict, grads, lr: float, out: Optional[dict]) -> dict:
    """``p - (lr * g).to(p.dtype)`` leaf by leaf (``grads`` in `_slots`
    order), written into ``out`` (fresh tensors by default)."""
    out = {n: torch.empty(v.shape, dtype=v.dtype, device=v.device)
           for n, v in params.items()} if out is None else out
    with torch.no_grad():
        for (n, b, p), g in zip(_slots(params), grads, strict=True):
            dst = out[n] if b is None else out[n][b]
            dst.copy_(p - (lr * g).to(p.dtype))
    return out


def _share(loss: torch.Tensor) -> torch.Tensor:
    """This rank's part of the loss under a `launch.tp` plan (1/D of its
    data share's mean), else the loss."""
    plan = current_plan()
    return loss if plan is None else plan.loss_share(loss)


def _value_and_grad(loss_fn: Callable, params: dict):
    """(loss, gradients in `_slots` order) of ``loss_fn(params as autograd
    leaves)``."""
    tree, flat = _leaves(params)
    loss = _share(loss_fn(tree))
    return loss.detach(), torch.autograd.grad(loss, flat)


# ------------------------------------------------------------ plain steps ----
def lm_loss(cfg: ModelConfig, params: dict, batch: dict,
            aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token CE (+ MoE aux).  labels = tokens shifted left.  Runs the
    differentiable SSD route with per-block remat."""
    logits, aux = model_logits(cfg, params, batch, use_ssd_kernel=False)
    logits = gather_vocab(logits)
    tok = batch["tokens"]
    labels = torch.cat([tok[:, 1:], tok[:, -1:]], dim=1)
    return xent_int_labels(logits, labels) + aux_weight * aux


def sgd_train_step(cfg: ModelConfig, params: dict, batch: dict, lr: float,
                   aux_weight: float = 0.01, out: Optional[dict] = None):
    """The local step ("1. Update" at LLM scale): plain SGD, the paper's
    optimizer.  Returns (new params, loss); ``out`` receives them."""
    loss, grads = _value_and_grad(
        lambda p: lm_loss(cfg, p, batch, aux_weight), params)
    return _apply_sgd(params, grads, lr, out), loss


# ------------------------------------------------------- DS-FL hybrid step ---
def dsfl_client_loss(cfg: ModelConfig, params: dict, private_batch: dict,
                     open_batch: dict, teacher, hp: LLMDsflHP):
    """CE on private tokens + gamma * KD on the open batch (Eqs. 1 + 10
    fused into one local step)."""
    ce = lm_loss(cfg, params, private_batch, hp.aux_weight)
    logits_o, _ = model_logits(cfg, params, open_batch, use_ssd_kernel=False)
    logits_o = gather_vocab(logits_o)
    if callable(teacher):       # an exchange still in flight: wait now
        teacher = teacher()
    if hp.topk is not None:
        tv, ti = teacher
        kd = topk_distill_xent(logits_o, tv, ti)
    else:
        kd = distill_xent(logits_o, teacher, use_kernel=hp.use_kernel)
    return ce + hp.gamma * kd


def _split_mb(tree, m: int, i: int):
    """Microbatch i of m along the leading (batch) axis of every leaf."""
    if isinstance(tree, dict):
        return {k: _split_mb(v, m, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_split_mb(v, m, i) for v in tree)
    n = tree.shape[0] // m
    return tree[i * n:(i + 1) * n]


def dsfl_client_step(cfg: ModelConfig, params: dict, private_batch: dict,
                     open_batch: dict, teacher, hp: LLMDsflHP,
                     out: Optional[dict] = None):
    """One hybrid step.  ``hp.microbatches = m > 1`` accumulates the
    gradients of m equal microbatches in fp32 (each scaled by 1/m), as the
    reference's scan does.  Returns (new params, loss)."""
    loss_of = lambda pb, ob, tb: (lambda p: dsfl_client_loss(
        cfg, p, pb, ob, tb, hp))
    if hp.microbatches <= 1:
        loss, grads = _value_and_grad(
            loss_of(private_batch, open_batch, teacher), params)
    else:
        m = hp.microbatches
        teacher = teacher() if callable(teacher) else teacher
        leaves, flat = _leaves(params)
        grads = [torch.zeros(f.shape, dtype=F32, device=f.device)
                 for f in flat]
        loss = torch.zeros((), dtype=F32, device=flat[0].device)
        for i in range(m):
            mb = [_split_mb(t, m, i) for t in (private_batch, open_batch,
                                                teacher)]
            li = _share(loss_of(*mb)(leaves))
            for acc, g in zip(grads, torch.autograd.grad(li, flat)):
                acc.add_(g.to(F32) / m)
            loss = loss + li.detach() / m
    return _apply_sgd(params, grads, hp.lr, out), loss


# ----------------------------------------------------------- round step ------
def predict_open_probs(cfg: ModelConfig, params: dict, open_batch: dict,
                       use_kernel: bool = False) -> torch.Tensor:
    """"2. Prediction": per-token class distribution (B, S, V) bf16 on the
    open batch, without gradients (through K5 with ``use_kernel``)."""
    with torch.no_grad():
        logits, _ = model_logits(cfg, params, open_batch,
                                 use_ssd_kernel=use_kernel)
        logits = gather_vocab(logits)
        return torch.softmax(logits.to(F32), dim=-1).to(BF16)


def _predict_lanes(cfg, stacked, lanes, open_batch, use_kernel):
    """(len(lanes), B, S, V) bf16 uploads of the given clients."""
    return torch.stack([predict_open_probs(cfg, client(stacked, k),
                                           open_batch, use_kernel)
                        for k in lanes])


def _is_sparse_round(K: int, hp: LLMDsflHP, weights, active_budget) -> bool:
    """Whether a round takes the participation-sparse plane; the exchange
    and finish halves both ask, so they cannot disagree."""
    return (weights is not None and active_budget is not None
            and active_budget < K and hp.topk is None)


def _lanes_of(stacked: dict, pod) -> tuple[int, int, int]:
    """(K, first global lane, local lane count) of a client stack: the
    whole client axis, or this rank's part of it."""
    n = n_clients(stacked)
    return (n, 0, n) if pod is None else (n * pod.size, n * pod.rank, n)


def _local(idx: torch.Tensor, lo: int, n: int) -> list[int]:
    """The global lanes ``idx`` that lie in [lo, lo + n), as local lanes."""
    return [k - lo for k in idx.tolist() if lo <= k < lo + n]


def dsfl_exchange(cfg: ModelConfig, stacked: dict, open_batch: dict,
                  hp: LLMDsflHP, weights=None, mask=None,
                  active_budget=None, pod=None, async_op: bool = False):
    """The wire leg of a round, "2. Prediction" + "3. Upload".  Returns the
    exchange buffers `dsfl_round_finish` consumes: with ``hp.topk`` the
    (K, B, S, k) ``(values, indices)`` pair; dense, the (K, B, S, V)
    upload stack; participation-sparse, the (m, B, S, V) stack of the
    active lanes.  With ``pod`` the buffers are the gathered (K, ...)
    stacks (the sparse one with exact zeros in the inactive lanes), or
    `Pending` gathers with ``async_op``."""
    K, lo, n = _lanes_of(stacked, pod)
    sparse = _is_sparse_round(K, hp, weights, active_budget)
    if sparse:
        idx = active_indices(weights if mask is None else mask, active_budget)
        if pod is None:
            return (_predict_lanes(cfg, stacked, idx.tolist(), open_batch,
                                   hp.use_kernel),)
        local = _local(idx, lo, n)
        probs = torch.zeros(
            (n,) + tuple(open_batch["tokens"].shape) + (cfg.eff_vocab,),
            dtype=BF16, device=open_batch["tokens"].device)
        for k in local:
            probs[k] = predict_open_probs(cfg, client(stacked, k),
                                          open_batch, hp.use_kernel)
    else:
        probs = _predict_lanes(cfg, stacked, range(n), open_batch,
                               hp.use_kernel)
    if hp.topk is not None:
        tv, ti = topk_compress(probs, hp.topk)
        # the wire carries int32 indices, as the reference's
        uploads = (tv, ti if pod is None else ti.to(torch.int32))
    else:
        uploads = (probs,)
    if pod is None:
        return uploads
    gather = all_gather_clients_async if async_op else all_gather_clients
    return tuple(gather(u, pod) for u in uploads)


def _arrived(inflight) -> tuple:
    """The exchange buffers, waiting on any still in flight."""
    return tuple(b.wait() if isinstance(b, Pending) else b for b in inflight)


def _step_lanes(stacked: dict, lanes, step: Callable, keep=None,
                fill: str = "old"):
    """A fresh (K, ...) stack with lane k of ``lanes`` written by ``step(k,
    out_k)`` (which returns the lane's loss); a lane whose ``keep[k]`` is
    False is computed and then takes its old parameters (the reference's
    ``select_clients``); every lane not run takes its old parameters
    (``fill="old"``) or exact zeros (``fill="zeros"``, the reference's
    ``scatter_zeros``).  Returns (stack, (K,) losses, 0 where not run)."""
    K = n_clients(stacked)
    new = {n: torch.empty(v.shape, dtype=v.dtype, device=v.device)
           for n, v in stacked.items()}
    dev = next(iter(stacked.values())).device
    losses = [torch.zeros((), dtype=F32, device=dev)] * K
    run = set(int(k) for k in lanes)
    for k in range(K):
        if k in run:
            losses[k] = step(k, client(new, k)).to(F32)
            if keep is None or keep[k]:
                continue
        elif fill == "zeros":
            for v in new.values():
                v[k].zero_()
            continue
        for n, v in new.items():
            v[k].copy_(stacked[n][k])
    return new, torch.stack(losses)


def pod_reduce(terms, pod) -> dict:
    """{name: (the sum of ``term`` over the pod ranks / div) as dtype} of
    ``(name, f32 term, dtype, div)`` items, each term's all-reduce in
    flight while the next term is computed (at most two f32 terms live)."""
    out, last = {}, None
    for name, term, dtype, div in terms:
        issued = (name, all_reduce_sum_async(term, pod), dtype, div)
        if last is not None:
            out[last[0]] = (last[1].wait() / last[3]).to(last[2])
        last = issued
    if last is not None:
        out[last[0]] = (last[1].wait() / last[3]).to(last[2])
    return out


def _all_losses(losses: torch.Tensor, pod) -> torch.Tensor:
    """The (K,) losses of every client: this rank's (its data shares
    summed over "data" under a `launch.tp` plan), gathered over ``pod``."""
    plan = current_plan()
    if plan is not None:
        losses = plan.sum_losses(losses)
    return losses if pod is None else all_gather_clients(losses, pod)


def dsfl_round_finish(cfg: ModelConfig, stacked: dict, private_batches: dict,
                      open_batch: dict, inflight, hp: LLMDsflHP, weights=None,
                      mask=None, active_budget=None, pod=None):
    """The compute leg of a round: "4. Aggregation" + "5. Broadcast" + the
    hybrid CE+KD client step on the exchange buffers ``inflight``.
    Returns (new stacked params, loss)."""
    K, lo, n = _lanes_of(stacked, pod)
    act = weights if mask is None else mask
    sparse = _is_sparse_round(K, hp, weights, active_budget)
    idx = active_indices(act, active_budget) if sparse else None
    # the private-data CE runs before the exchange is awaited (`_Teacher`)
    teacher = _Teacher(functools.partial(_teacher, cfg, inflight, hp,
                                         weights, K, idx, pod))
    if sparse:
        # participation-sparse: only the active lanes train
        lanes = _local(idx, lo, n)
    else:
        lanes = range(n)
    if hp.topk is not None:
        # the exchange leg is compressed; the distillation uses the dense
        # teacher
        hp = dataclasses.replace(hp, topk=None)
    keep = (None if weights is None
            else (act.to(F32) > 0)[lo:lo + n].tolist())

    def step(k, out):
        _, loss = dsfl_client_step(
            cfg, client(stacked, k), client(private_batches, k), open_batch,
            teacher, hp, out=out)
        return loss

    new, losses = _step_lanes(stacked, lanes, step, keep)
    if not lanes:
        _arrived(inflight)      # a rank with no lane still completes the gather
    losses = _all_losses(losses, pod)
    if weights is None:
        return new, losses.mean()
    # absent clients neither update nor average into the loss
    return new, masked_mean(losses, act.to(F32) > 0)


class _Teacher:
    """The round's teacher, made at its first call and kept."""

    def __init__(self, make: Callable):
        self._make, self._value = make, None

    def __call__(self):
        if self._make is not None:
            self._value, self._make = self._make(), None
        return self._value


def _teacher(cfg: ModelConfig, inflight, hp: LLMDsflHP, weights, K: int,
             idx, pod):
    """The bf16 teacher from the exchange buffers: the sparse round's
    active uploads scattered into exact zeros (gathered so already over
    ``pod``), the top-k pairs densified, or the dense stack."""
    bufs = _arrived(inflight)
    if idx is not None:
        stack = bufs[0] if pod is not None else scatter_zeros(bufs[0], K, idx)
        return _aggregate_teacher(stack, hp, weights)
    if hp.topk is not None:
        tv, ti = bufs
        dense = torch.zeros(tv.shape[:-1] + (cfg.eff_vocab,), dtype=F32,
                            device=tv.device).scatter(-1, ti.long(),
                                                      tv.to(F32))
        dense = constrain(dense, None, "batch", None, "model")
        return constrain(_aggregate_teacher(dense, hp, weights),
                         "batch", None, "model")
    return _aggregate_teacher(bufs[0], hp, weights)


def dsfl_round_step(cfg: ModelConfig, stacked: dict, private_batches: dict,
                    open_batch: dict, hp: LLMDsflHP, weights=None, mask=None,
                    active_budget=None, pod=None):
    """One DS-FL round: ``dsfl_round_finish(..., dsfl_exchange(...))``.

    ``stacked``: leaves (K, ...); ``private_batches``: {"tokens": (K, B,
    S)}; ``open_batch``: {"tokens": (B, S)}, shared by every client.
    ``weights`` (K,) makes it the partial-participation round (zero-weight
    clients contribute nothing and keep their parameters; ``mask`` names
    the participants when a stale one's weight decayed to zero);
    ``active_budget = m`` with ``weights`` computes only the m gathered
    active lanes, bitwise the dense weighted round.  The top-k exchange
    keeps the dense path, as in the reference.  With ``pod`` the stacks
    hold this rank's lanes and ``weights``/``mask`` stay (K,)."""
    inflight = dsfl_exchange(cfg, stacked, open_batch, hp, weights=weights,
                             mask=mask, active_budget=active_budget, pod=pod)
    return dsfl_round_finish(cfg, stacked, private_batches, open_batch,
                             inflight, hp, weights=weights, mask=mask,
                             active_budget=active_budget, pod=pod)


def _aggregate_teacher(probs: torch.Tensor, hp: LLMDsflHP, weights):
    """The teacher: `_aggregate` as bf16, which the clients distill on."""
    return _aggregate(probs, hp, weights).to(BF16)


def _aggregate(probs: torch.Tensor, hp: LLMDsflHP, weights):
    """SA/ERA over the client axis of (K, B, S, V) uploads, on their (K,
    B*S, V) view, as f32 (B, S, V); the weighted variants zero out absent
    clients and decay stale ones when ``weights`` are given, and
    ``hp.agg_edges > 1`` reduces through the edge -> server tree.  With
    ``hp.use_kernel``: K1 for ERA, K2 for the weighted variants and each
    edge's partial."""
    K, V = probs.shape[0], probs.shape[-1]
    lead = tuple(probs.shape[1:-1])
    p3 = probs.reshape(K, -1, V)
    uk = hp.use_kernel
    if hp.agg_edges > 1:
        w = (torch.ones((K,), dtype=F32, device=probs.device)
             if weights is None else weights)
        agg = (hierarchical_weighted_era(p3, w, hp.temperature, hp.agg_edges,
                                         use_kernel=uk)
               if hp.aggregation == "era"
               else hierarchical_weighted_sa(p3, w, hp.agg_edges,
                                             use_kernel=uk))
    elif weights is None:
        agg = (era(p3, hp.temperature, use_kernel=uk)
               if hp.aggregation == "era" else sa(p3))
    else:
        agg = (weighted_era(p3, weights, hp.temperature, use_kernel=uk)
               if hp.aggregation == "era"
               else weighted_sa(p3, weights, use_kernel=uk))
    return agg.reshape(lead + (V,))


def fedavg_round_step(cfg: ModelConfig, stacked: dict, private_batches: dict,
                      lr: float, weights=None, mask=None, active_budget=None,
                      pod=None):
    """FedAvg at LLM scale: a local SGD step on every client, then the
    parameter mean broadcast back to every lane (a stride-0 view).

    ``weights`` (K,) make the mean a weighted one (zero for absent clients,
    decayed for stale ones); ``mask`` names the participants whose losses
    average into the metric.  ``active_budget = m`` (with ``weights``)
    trains only the m gathered active lanes and leaves exact zeros in the
    others, which the weighted mean multiplies by their zero weights: the
    same result as the dense weighted round.  With ``pod`` each rank sums
    its lanes' f32 terms and the sums are all-reduced over it."""
    K, lo, n = _lanes_of(stacked, pod)
    sparse = (weights is not None and active_budget is not None
              and active_budget < K)
    act = weights if mask is None else mask
    lanes = (_local(active_indices(act, active_budget), lo, n) if sparse
             else range(n))

    def step(k, out):
        _, loss = sgd_train_step(cfg, client(stacked, k),
                                 client(private_batches, k), lr, out=out)
        return loss

    new, losses = _step_lanes(stacked, lanes, step, fill="zeros")
    losses = _all_losses(losses, pod)
    if weights is None:
        if pod is None:
            avg = {name: v.to(F32).mean(dim=0).to(v.dtype)
                   for name, v in new.items()}
        else:
            avg = pod_reduce(((name, v.to(F32).sum(dim=0), v.dtype, K)
                              for name, v in new.items()), pod)
        loss = losses.mean()
    else:
        w = weights.to(F32)
        w = w / torch.clamp(pinned_sum(w), min=1e-9)
        if pod is None:
            avg = {name: weighted_lane_sum(w, v).to(v.dtype)
                   for name, v in new.items()}
        else:
            w = w[lo:lo + n]
            avg = pod_reduce(((name, weighted_lane_sum(w, v).contiguous(),
                               v.dtype, 1) for name, v in new.items()), pod)
        loss = masked_mean(losses, act.to(F32) > 0)
    del new
    return {name: a[None].expand((n,) + tuple(a.shape))
            for name, a in avg.items()}, loss
