"""Client-local training loops (mirrors ``repro/core/client.py``).

A client model is a functional pair ``apply(params, state, x, train) ->
(logits, new_state)`` over flat dicts of tensors.  The loops run a stack of
K clients at once: parameters, model state and optimizer state carry a
leading (K,) axis, and each minibatch step is one
``vmap(grad_and_value(loss))`` over that axis.  The reference's
``lax.scan`` over epochs and batches becomes a Python loop.

Minibatch order comes from epoch permutations of shape (K, epochs, nb, bs):
each epoch is a permutation of the client's n items cut to nb = n // bs
whole batches (the tail is dropped, as the reference's ``_epoch_perm``
drops it).  Every loop takes them precomputed (``perms=``): the algorithms
draw them keyed on each lane's global client id (`perms_for`,
`core.prng.epoch_perms`), and a test can hand in the reference's own draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.func import grad_and_value, vmap

from ..optim.optimizers import Optimizer
from . import prng
from .losses import distill_xent, softmax_xent, xent_int_labels


@dataclass(frozen=True)
class LocalSpec:
    apply_fn: Callable
    opt: Optimizer
    epochs: int
    batch_size: int


def _check_perms(spec: LocalSpec, L: int, n: int, perms):
    """``perms`` of one loop of L lanes over n items, shape-checked."""
    if perms is None:
        raise ValueError("pass precomputed perms (core.client.perms_for)")
    bs = min(spec.batch_size, n)     # clamp: batch_size > n gives zero batches
    expected = (L, spec.epochs, n // bs, bs)
    if tuple(perms.shape) != expected:
        raise ValueError(f"perms must have shape {expected}, got "
                         f"{tuple(perms.shape)}")
    return perms


def perms_for(spec: LocalSpec, n: int, ids, perms=None, seed: int = 0,
              rnd: int = 0, leg: str = "update"):
    """The (L, epochs, nb, bs) permutations of one loop over n items for the
    L lanes whose global client ids are ``ids``: ``perms`` (injected, one
    row per lane) checked and moved to ``ids``' device, or drawn keyed on
    (seed, round, leg, id), so that a client's rows do not depend on its
    lane, its slab or how many lanes the round computes."""
    if perms is None:
        return prng.epoch_perms(seed, rnd, leg, ids, spec.epochs, n,
                                min(spec.batch_size, n))
    return _check_perms(spec, ids.shape[0], n, perms).to(ids.device)


def _train(spec: LocalSpec, params, state, opt_state, perms, loss_fn, batch):
    """E epochs of minibatch SGD on the (K, ...) stack.  ``batch(idx)``
    gathers the (K, bs, ...) inputs and targets of one step; ``loss_fn(p, s,
    xb, tb) -> (loss, new_state)`` is one client's loss."""
    step_fn = vmap(grad_and_value(loss_fn, has_aux=True))
    K, epochs, nb, _ = perms.shape
    step = 0
    epoch_losses = []
    for e in range(epochs):
        losses = []
        for b in range(nb):
            xb, tb = batch(perms[:, e, b])
            grads, (loss, state) = step_fn(params, state, xb, tb)
            params, opt_state = spec.opt.update(grads, params, opt_state, step)
            step += 1
            losses.append(loss)
        epoch_losses.append(torch.stack(losses, dim=1).mean(dim=1))
    return (params, state, opt_state,
            torch.stack(epoch_losses, dim=1).mean(dim=1))


def local_update(spec: LocalSpec, params, state, opt_state, x, y, perms,
                 distill_extra=None, gamma: float = 0.0):
    """"1. Update": E epochs of minibatch supervised training of K clients
    on their private data x: (K, n, ...), y: (K, n).  ``distill_extra``
    (K, n, C), per-sample soft targets aligned with x and gathered per batch
    like the labels, adds FD's regularizer (Eq. 7): gamma * CE(targets) on
    the private inputs.  Returns the new (params, state, opt_state) stacks
    and each client's mean loss (K,)."""
    K, n = y.shape[:2]
    perms = _check_perms(spec, K, n, perms).to(x.device)
    rows = torch.arange(K, device=x.device)[:, None]

    def batch(idx):
        if distill_extra is None:
            return x[rows, idx], y[rows, idx]
        return x[rows, idx], (y[rows, idx], distill_extra[rows, idx])

    def loss_fn(p, s, xb, tb):
        logits, ns = spec.apply_fn(p, s, xb, True)
        if distill_extra is None:
            return xent_int_labels(logits, tb), ns
        yb, tgt = tb
        return (xent_int_labels(logits, yb)
                + gamma * softmax_xent(logits, tgt)), ns

    return _train(spec, params, state, opt_state, perms, loss_fn, batch)


def local_distill(spec: LocalSpec, params, state, opt_state, x_open,
                  teacher_probs, perms):
    """"6. Distillation" (Eq. 10): K clients train on the shared open batch
    x_open: (n, ...) against the broadcast global logit (n, C)."""
    K = next(iter(params.values())).shape[0]
    n = x_open.shape[0]
    perms = _check_perms(spec, K, n, perms).to(x_open.device)

    def batch(idx):
        return x_open[idx], teacher_probs[idx]

    def loss_fn(p, s, xb, tb):
        logits, ns = spec.apply_fn(p, s, xb, True)
        return distill_xent(logits, tb), ns

    return _train(spec, params, state, opt_state, perms, loss_fn, batch)


def predict_probs(apply_fn: Callable, params, state, x, batch_size: int = 0):
    """Inference probabilities of one model on the open batch ("2.
    Prediction", Eq. 9).  ``batch_size > 0`` runs the forward pass chunk by
    chunk so a large open batch never holds all activations at once."""
    with torch.no_grad():
        n = x.shape[0]
        if batch_size <= 0 or batch_size >= n:
            logits, _ = apply_fn(params, state, x, False)
            return torch.softmax(logits.float(), dim=-1)
        out = []
        for i in range(0, n, batch_size):
            logits, _ = apply_fn(params, state, x[i:i + batch_size], False)
            out.append(torch.softmax(logits.float(), dim=-1))
        return torch.cat(out, dim=0)
