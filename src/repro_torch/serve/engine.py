"""Slot-based continuous-batching inference engine (mirrors
``repro/serve/engine.py``).

`ServeEngine` holds a fixed-capacity decode batch — ``slots`` lanes of the
decode cache (`models.api`): ring-buffer KV caches of ``seq_budget``
positions for attention archs, the O(1) SSM state for Mamba — and drives
it with:

  * one **decode step** for all slots at once: the slot axis is the batch
    axis of the cache, each slot at its own position (the reference vmaps
    one scalar position over the slots), greedy argmax on the device.  The
    step writes each slot's new K/V into its ring buffer in place (the
    reference donates the cache).  Free slots compute garbage lanes that
    nothing reads, so admitting and evicting requests never changes a
    shape.  An MoE FFN routes each slot's token as a group of its own
    (``moe_group_size`` 1 in the decode step's config), as the reference's
    vmap over the slots does: slots never take each other's expert
    capacity.
  * a **fused decode chunk**: ``step(now, decode_chunk=d)`` runs d decode
    steps back to back on device tensors — token, position, tokens still
    owed and prompt-tail tokens still to force — and syncs the host
    **once**, on the (d, N) token matrix.  Prompt-tail tokens ride a
    precomputed forced-token matrix; lanes that finish (max tokens or EOS)
    freeze their token and position inside the chunk.  Token-identical to
    d single steps; mid-chunk finishers are stamped at their true virtual
    sub-step time (``now + j * step_dt``).
  * a **prefill-insert** per request: prefill the largest bucket-length
    *prefix* of the prompt in one full-sequence shot (its ring buffers
    sized by ``seq_budget``), write the resulting one-request cache into
    the claimed slot in place, and feed the prompt tail
    through the decode step as forced tokens.  No prompt padding enters the
    model, so a request decodes token-identically to serving it alone.
    Bucket 1 is always a bucket, so a prompt shorter than every configured
    bucket prefills its first token and forces the rest.
  * a **batched prefill-insert**: ``insert_batch`` admits up to ``slots``
    same-bucket requests in one shot — the (m, n) token block prefills as
    one batch and the per-request caches land through a slot-index vector.
    The reference pads m up to a power-of-two class to bound its compiles;
    the port runs eagerly and prefills exactly the m rows.

Per-slot bookkeeping (prompt tail, generated tokens, timestamps) is plain
host Python.  Every Mamba prefill's within-chunk SSD blocks go through K5
(`kernels.ops.ssd_chunk`); attention is plain PyTorch, as in the
reference.

The reference's compiled-program counts (``compile_counts``) have no
counterpart here yet: the port runs eagerly, and CUDA-graph capture counts
take their place in a later slice.  Its telemetry is the reference's:
``serve.prefill`` and ``serve.decode`` spans (host time around a shot or a
step through its host sync) and the ``serve.*`` counters, gauge and
histograms, published where a tracer or registry is installed
(`obs.cli`).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..device import resolve_device
from ..models.api import model_decode_step, model_init_cache, model_prefill
from ..models.base import ModelConfig
from .queue import Request, Response, bucket_of

DEFAULT_BUCKETS = (16, 32, 64, 128)


@dataclass
class _SlotTask:
    """Host-side state of one occupied slot."""
    req: Request
    pending: list                       # prompt-tail tokens not yet fed
    generated: list = field(default_factory=list)
    admitted_at: float = 0.0
    first_token_at: Optional[float] = None


def _mismatches(like: dict, new: dict) -> list:
    """Every leaf of ``new`` that differs from ``like`` in name, shape or
    dtype, named (the port's counterpart of the reference's
    ``checkpoint.tree_mismatches``)."""
    msgs = [f"missing leaf {k}" for k in sorted(set(like) - set(new))]
    msgs += [f"unexpected leaf {k}" for k in sorted(set(new) - set(like))]
    for k in sorted(set(like) & set(new)):
        a, b = like[k], new[k]
        if tuple(a.shape) != tuple(b.shape):
            msgs.append(f"{k}: shape {tuple(b.shape)} != expected "
                        f"{tuple(a.shape)}")
        elif a.dtype != b.dtype:
            msgs.append(f"{k}: dtype {b.dtype} != expected {a.dtype}")
    return msgs


class ServeEngine:
    """Continuous-batching greedy decoder over a fixed slot budget.

    ``seq_budget`` caps prompt + generation per request.  ``buckets`` are the
    prefill prefix lengths; bucket 1 is always added.  ``params`` is the
    flat parameter dict, on ``device``: the card unless the caller asks for
    the CPU (then every kernel wrapper computes its plain version).
    Token-only architectures.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *, slots: int = 4,
                 seq_budget: int = 128,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 eos_id: Optional[int] = None, version: int = 0,
                 device="cuda"):
        if cfg.arch_type in ("vlm", "audio"):
            raise NotImplementedError(
                f"ServeEngine serves token-only archs; {cfg.arch_type!r} "
                "needs modality inputs per request")
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        self.device = resolve_device(device)
        elsewhere = sorted(k for k, v in params.items()
                           if v.device.type != self.device.type)
        if elsewhere:
            raise ValueError(f"ServeEngine on {self.device}: parameters "
                             f"{elsewhere[:3]} lie on "
                             f"{params[elsewhere[0]].device}")
        self.cfg = cfg
        # the reference vmaps its decode step over the slots, so an MoE
        # FFN sees one token a call: a group of one, whatever the slots do
        self._decode_cfg = cfg.replace(moe_group_size=1)
        self.params = params
        self.slots = int(slots)
        self.seq_budget = int(seq_budget)
        self.buckets = tuple(sorted({1} | {int(b) for b in buckets
                                           if b <= self.seq_budget}))
        self.eos_id = eos_id
        self.version = int(version)

        self.cache = model_init_cache(cfg, params, self.slots, self.seq_budget)
        self.tok = np.zeros((self.slots,), np.int64)
        self.pos = np.zeros((self.slots,), np.int64)
        self.tasks: list = [None] * self.slots
        self.completed: list = []       # drained by pop_completed()
        self.n_steps = 0                # decode sub-steps accounted
        self.n_dispatches = 0           # host syncs those steps cost
        self.n_inserts = 0              # requests admitted
        self.n_prefill_shots = 0        # prefill passes
        self.n_swaps = 0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _decode(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """One decode step of every slot; updates the cache, returns the
        (N,) greedy next tokens on the device."""
        logits, self.cache = model_decode_step(self._decode_cfg, self.params,
                                               self.cache, tok, pos)
        return torch.argmax(logits, dim=-1)

    def _prefill(self, toks: np.ndarray):
        """Prefill an (m, n) token block; returns (last-token logits, the
        m requests' caches)."""
        return model_prefill(self.cfg, self.params,
                             {"tokens": self._dev(toks)}, self.seq_budget)

    def reset(self) -> None:
        """Drop all in-flight requests and re-zero the cache (in place) and
        positions."""
        for v in self.cache.values():
            v.zero_()
        self.tok[:] = 0
        self.pos[:] = 0
        self.tasks = [None] * self.slots
        self.completed = []

    # ----------------------------------------------------------- occupancy ---
    def free_slots(self) -> list:
        return [i for i, t in enumerate(self.tasks) if t is None]

    @property
    def n_active(self) -> int:
        return self.slots - len(self.free_slots())

    def pop_completed(self) -> list:
        out, self.completed = self.completed, []
        return out

    def prefill_len(self, prompt_len: int) -> int:
        return bucket_of(prompt_len, self.buckets)

    # -------------------------------------------------------------- insert ---
    def _check_request(self, req: Request) -> None:
        S = req.prompt_len
        if S < 1:
            raise ValueError(f"request {req.id}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.id}: max_new_tokens must be >= 1")
        if S + req.max_new_tokens > self.seq_budget:
            raise ValueError(
                f"request {req.id}: prompt ({S}) + max_new_tokens "
                f"({req.max_new_tokens}) exceeds seq_budget="
                f"{self.seq_budget}")

    def _admit_task(self, req: Request, slot: int, n: int, first: int,
                    now: float) -> None:
        task = _SlotTask(req=req, pending=list(req.tokens[n:]),
                         admitted_at=float(now))
        self.tasks[slot] = task
        self.pos[slot] = n
        if task.pending:
            # the prefix's next-token prediction is a known prompt token:
            # discard the argmax, force the tail through the decode step
            self.tok[slot] = task.pending.pop(0)
        else:
            self._emit(slot, int(first), now)   # first generated token

    def insert(self, req: Request, now: float = 0.0) -> int:
        """Claim a free slot for ``req``: one prefill of the bucket prefix,
        its cache written into the slot, the prompt tail queued as forced
        tokens for the shared decode step.  Returns the slot index."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot; admit at most free_slots()")
        self._check_request(req)
        slot = free[0]
        n = self.prefill_len(req.prompt_len)
        with obs.span("serve.prefill", "serve", req=req.id, bucket=n,
                      slot=slot):
            logits, one = self._prefill(np.asarray(req.tokens[:n],
                                                   np.int64)[None])
            for k, full in self.cache.items():
                full[:, slot].copy_(one[k][:, 0])
            first = int(torch.argmax(logits[0]))
        self.n_inserts += 1
        self.n_prefill_shots += 1
        reg = obs.current_registry()
        if reg is not None:
            reg.counter("serve.inserts").inc()
            reg.histogram("serve.prefill_batch_size").observe(1)
        self._admit_task(req, slot, n, first, now)
        return slot

    def insert_batch(self, reqs: Sequence[Request],
                     now: float = 0.0) -> list:
        """Admit up to ``slots`` same-bucket requests in **one** prefill
        shot: their bucket prefixes prefill as a single (m, n) batch and the
        per-request caches land through a slot-index vector.  Token-identical
        to inserting each request alone.  Returns the claimed slot indices,
        one per request, in order."""
        reqs = list(reqs)
        if not reqs:
            return []
        free = self.free_slots()
        if len(reqs) > len(free):
            raise RuntimeError(
                f"{len(reqs)} requests for {len(free)} free slots; "
                "admit at most free_slots()")
        ns = set()
        for req in reqs:
            self._check_request(req)
            ns.add(self.prefill_len(req.prompt_len))
        if len(ns) != 1:
            raise ValueError(
                "insert_batch needs same-bucket requests (one prefill length "
                f"per shot); got buckets {sorted(ns)} — group with "
                "AdmissionQueue.admit(..., group=True)")
        n = ns.pop()
        m = len(reqs)
        claimed = free[:m]
        toks = np.asarray([req.tokens[:n] for req in reqs], np.int64)
        with obs.span("serve.prefill", "serve", bucket=n, batch=m,
                      slots=list(map(int, claimed))):
            logits, many = self._prefill(toks)
            lanes = self._dev(np.asarray(claimed, np.int64))
            for k, full in self.cache.items():
                full.index_copy_(1, lanes, many[k])
            firsts = torch.argmax(logits, dim=-1).cpu().numpy()
        self.n_inserts += m
        self.n_prefill_shots += 1
        reg = obs.current_registry()
        if reg is not None:
            reg.counter("serve.inserts").inc(m)
            reg.histogram("serve.prefill_batch_size").observe(m)
        for row, (req, slot) in enumerate(zip(reqs, claimed)):
            self._admit_task(req, slot, n, int(firsts[row]), now)
        return claimed

    # ---------------------------------------------------------------- step ---
    def step(self, now: float = 0.0, decode_chunk: int = 1,
             step_dt: float = 0.0) -> list:
        """Decode for every slot (free lanes compute garbage that nothing
        reads).  ``decode_chunk=d`` runs d steps with a single host sync;
        mid-chunk finishers are stamped at their true virtual sub-step time
        ``now + j * step_dt``.  Returns the requests that finished."""
        if self.n_active == 0:
            return []
        d = int(decode_chunk)
        if d < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        if d > 1:
            return self._step_chunk(now, d, float(step_dt))
        with obs.span("serve.decode", "serve", active=self.n_active, chunk=1):
            nxt = self._decode(self._dev(self.tok), self._dev(self.pos))
            nxt = nxt.cpu().numpy()     # the per-step host sync: (N,) tokens
        self.n_steps += 1
        self.n_dispatches += 1
        reg = obs.current_registry()
        if reg is not None:
            reg.counter("serve.decode_steps").inc()
            reg.gauge("serve.active_slots").set(self.n_active)
        done_before = len(self.completed)
        for i, task in enumerate(self.tasks):
            if task is None:
                continue
            self.pos[i] += 1
            if task.pending:
                # still consuming the prompt tail: the model's prediction is
                # superseded by the known next prompt token
                self.tok[i] = task.pending.pop(0)
            else:
                self._emit(i, int(nxt[i]), now)
        return self.completed[done_before:]

    def _step_chunk(self, now: float, d: int, step_dt: float) -> list:
        """d decode steps on device state with one (d, N) token sync, then a
        host replay of the per-step bookkeeping the d=1 loop would have
        done.  ``n_steps`` advances by the sub-steps that still had an
        active lane."""
        N = self.slots
        forced = np.zeros((d, N), np.int64)
        forced_len = np.zeros((N,), np.int64)
        remaining = np.zeros((N,), np.int64)
        for i, task in enumerate(self.tasks):
            if task is None:
                continue
            tail = task.pending[:d]
            forced[:len(tail), i] = tail
            forced_len[i] = len(tail)
            remaining[i] = task.req.max_new_tokens - len(task.generated)
        with obs.span("serve.decode", "serve", active=self.n_active, chunk=d):
            tok, pos = self._dev(self.tok), self._dev(self.pos)
            rem, fl, forced_t = (self._dev(remaining), self._dev(forced_len),
                                 self._dev(forced))
            mat = torch.empty((d, N), dtype=torch.int64, device=self.device)
            for j in range(d):
                nxt = self._decode(tok, pos)
                mat[j] = nxt
                done = rem <= 0             # finished before this sub-step
                is_forced = ~done & (fl > 0)
                emitting = ~done & (fl <= 0)
                rem = torch.where(emitting, rem - 1, rem)
                if self.eos_id is not None:
                    rem = torch.where(emitting & (nxt == self.eos_id), 0, rem)
                finishing = emitting & (rem <= 0)
                tok = torch.where(is_forced, forced_t[j],
                                  torch.where(emitting & ~finishing, nxt, tok))
                pos = torch.where(done, pos, pos + 1)
                fl = torch.where(is_forced, fl - 1, fl)
            mat = mat.cpu().numpy()         # the chunk's one host sync
            tok, pos = tok.cpu().numpy(), pos.cpu().numpy()
        self.n_dispatches += 1
        done_before = len(self.completed)
        used = 0
        for j in range(d):
            if all(t is None for t in self.tasks):
                break                   # the d=1 loop would have stopped
            used += 1
            t_j = now + j * step_dt     # true virtual time of sub-step j
            for i, task in enumerate(self.tasks):
                if task is None:
                    continue
                if task.pending:
                    task.pending.pop(0)     # forced: prediction superseded
                else:
                    self._emit(i, int(mat[j, i]), t_j)
        # the device chained tok/pos through the same masking the replay
        # just applied (finished lanes frozen), so these ARE the d=1 state
        self.tok, self.pos = tok, pos
        self.n_steps += used
        reg = obs.current_registry()
        if reg is not None:
            reg.counter("serve.decode_steps").inc(used)
            reg.counter("serve.decode_chunks").inc()
            reg.gauge("serve.active_slots").set(self.n_active)
        return self.completed[done_before:]

    def _emit(self, slot: int, token: int, now: float) -> None:
        """Record one generated token for ``slot``; evict on completion."""
        task = self.tasks[slot]
        if task.first_token_at is None:
            task.first_token_at = float(now)
            reg = obs.current_registry()
            if reg is not None:
                # admit -> first token, in the caller's clock
                reg.histogram("serve.admit_to_first_token_s").observe(
                    task.first_token_at - task.admitted_at)
        task.generated.append(token)
        done = (len(task.generated) >= task.req.max_new_tokens
                or (self.eos_id is not None and token == self.eos_id))
        if done:
            self.completed.append(Response(
                id=task.req.id, prompt_len=task.req.prompt_len,
                tokens=tuple(task.generated), weights_version=self.version,
                arrival=task.req.arrival, admitted_at=task.admitted_at,
                first_token_at=task.first_token_at, finished_at=float(now)))
            self.tasks[slot] = None
        else:
            self.tok[slot] = token

    # ---------------------------------------------------------------- swap ---
    def swap_weights(self, new_params: dict,
                     version: Optional[int] = None) -> None:
        """Hot-swap the serving weights.  ``new_params`` must match the
        current params exactly (names, shapes, dtypes; every mismatch is
        named).  The new values are copied into the engine's existing
        parameter storage in place, the port's counterpart of the
        reference's donated buffers: resident weight memory does not grow,
        and tensors a caller handed in as ``params`` see the new values.
        ``step`` syncs before it returns, so a swap always lands at a
        decode-chunk boundary: every token of one chunk comes from one
        weights version."""
        msgs = _mismatches(self.params, new_params)
        if msgs:
            raise ValueError(
                "hot-swapped serving weights do not match the expected "
                "parameters (same arch/config?):\n  " + "\n  ".join(msgs))
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(new_params[k])
        self.version = int(version) if version is not None \
            else self.version + 1
        self.n_swaps += 1

    # ----------------------------------------------------------- telemetry ---
    def stats(self) -> dict:
        return {"slots": self.slots, "active": self.n_active,
                "steps": self.n_steps, "dispatches": self.n_dispatches,
                "inserts": self.n_inserts,
                "prefill_shots": self.n_prefill_shots,
                "swaps": self.n_swaps, "version": self.version}
