"""Dataset assembly for federated experiments: private/open/test sets, the
client stacks, and the cohort plane's data providers (mirrors
``FederatedImageTask``, ``build_image_task``, ``SlabTask``,
``ArrayProvider``, ``SyntheticProvider``, ``FederatedLMTask``,
``build_lm_task``, ``lm_private_batches`` and ``lm_open_batch`` of
``repro/data/pipeline.py``)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import attacks, prng
from ..device import generator, resolve_device
from . import partition, synthetic


@dataclass
class FederatedImageTask:
    x_clients: torch.Tensor      # (K, I_k, H, W, 1)
    y_clients: torch.Tensor      # (K, I_k)
    open_x: torch.Tensor         # (I_o, H, W, 1)
    x_test: torch.Tensor
    y_test: torch.Tensor
    n_classes: int


def build_image_task(seed: int, K: int, n_private: int, n_open: int,
                     n_test: int, distribution: str = "non_iid",
                     hw: int = 16, n_classes: int = 10, noisy_open: int = 0,
                     device="cuda") -> FederatedImageTask:
    """Private, open and test sets of the ``digits`` task, made on
    ``device`` from one generator seeded with ``seed``, and the private
    set dealt to K clients: ``"iid"``, the paper's ``"non_iid"`` or
    ``"dirichlet:<alpha>"``.  ``noisy_open=N`` mixes N foreign samples
    (``make_fashion_noise``) into the open set, shuffled (the noisy-open
    attack)."""
    gen = generator(device, seed)
    x, y = synthetic.make_digits(gen, n_private, n_classes, hw)
    open_x, _ = synthetic.make_digits(gen, n_open, n_classes, hw)
    x_test, y_test = synthetic.make_digits(gen, n_test, n_classes, hw)
    if distribution == "iid":
        idx = partition.iid(gen, n_private, K)
    elif distribution == "non_iid":
        idx = partition.shard_non_iid(gen, y, K, 2)
    elif distribution.startswith("dirichlet"):
        alpha = float(distribution.split(":")[1])
        idx = partition.dirichlet(gen, y, K, alpha, n_classes)
    else:
        raise ValueError(distribution)
    xc, yc = partition.gather_clients(x, y, idx)
    if noisy_open:
        noise_x, _ = synthetic.make_fashion_noise(gen, noisy_open, n_classes,
                                                  hw)
        open_x = attacks.mix_noisy_open(open_x, noise_x, gen)
    return FederatedImageTask(xc, yc, open_x, x_test, y_test, n_classes)


# -------------------------------------------------- cohort data providers ----
@dataclass
class SlabTask:
    """An (S, ...) slab of client data with `FederatedImageTask`'s field
    names, so ``FedEngine.make_ctx`` reads a slab as it reads a dense task;
    the leading axis is the slab lane (``BatchCtx.cohort`` maps it to
    ids)."""
    x_clients: torch.Tensor
    y_clients: torch.Tensor
    open_x: torch.Tensor
    x_test: torch.Tensor = None
    y_test: torch.Tensor = None
    n_classes: int = 10


class ArrayProvider:
    """Cohort data over an in-memory dense task: ``slab(ids)`` gathers the
    clients' rows, so a cohort run sees the rows a dense run sees."""

    def __init__(self, task: FederatedImageTask):
        self.task = task
        self.n_clients = int(task.x_clients.shape[0])

    def slab(self, ids) -> SlabTask:
        t = self.task
        idx = torch.as_tensor(np.asarray(ids, np.int64),
                              device=t.x_clients.device)
        return SlabTask(t.x_clients.index_select(0, idx),
                        t.y_clients.index_select(0, idx), t.open_x,
                        t.x_test, t.y_test, t.n_classes)


class SyntheticProvider:
    """Per-id synthetic ``digits`` shards, made on demand: client g's
    private data is drawn from a generator keyed on (seed, "data", g), a
    function of (seed, g) alone, so a million-client fleet holds no data
    until a client is sampled and its rows do not depend on the order or
    company it is asked in.  The shared open and test sets are made once
    (from the "data_open" and "data_test" keys)."""

    def __init__(self, seed: int, n_clients: int, n_per_client: int,
                 n_open: int, n_test: int = 0, hw: int = 16,
                 n_classes: int = 10, device="cuda"):
        self.seed, self.n_clients = seed, int(n_clients)
        self.n_per_client, self.hw, self.n_classes = n_per_client, hw, n_classes
        self.device = resolve_device(device)
        self.open_x, _ = synthetic.make_digits(
            prng.generator(seed, 0, "data_open", 0, self.device), n_open,
            n_classes, hw)
        self.x_test = self.y_test = None
        if n_test:
            self.x_test, self.y_test = synthetic.make_digits(
                prng.generator(seed, 0, "data_test", 0, self.device), n_test,
                n_classes, hw)

    def slab(self, ids) -> SlabTask:
        seeds = prng.keys(self.seed, 0, "data",
                          torch.as_tensor(np.asarray(ids, np.int64)))
        shards = [synthetic.make_digits(
            torch.Generator(device=self.device).manual_seed(k),
            self.n_per_client, self.n_classes, self.hw)
            for k in seeds.tolist()]
        return SlabTask(torch.stack([x for x, _ in shards]),
                        torch.stack([y for _, y in shards]), self.open_x,
                        self.x_test, self.y_test, self.n_classes)


# ------------------------------------------------------------ LLM tasks ----
@dataclass
class FederatedLMTask:
    """LLM-scale federated task for `FedEngine`: batch dicts of token
    tensors instead of image tensors.  Labels derive from the tokens
    (next-token prediction), so ``y_clients`` stays an absent slot."""
    x_clients: dict           # {"tokens": (K, B, S), ...} private stacks
    open_x: dict              # {"tokens": (I_o, S), ...} the shared open set
    y_clients: None = None


def build_lm_task(seed: int, K: int, batch: int, seq: int, vocab: int,
                  n_open: int | None = None, extras_fn=None,
                  device="cuda") -> FederatedLMTask:
    """K private token batches and an open set of ``n_open`` (default
    ``batch``) sequences, drawn on ``device`` from one generator seeded
    with ``seed`` (private first, then open).  ``extras_fn(batch, gen) ->
    dict`` adds modality inputs (VLM patches, audio frames), drawn next
    from the same generator: each is broadcast over the client axis (a
    stride-0 view) and shared with the open set, mirroring the token
    layout."""
    gen = generator(device, seed)
    private = lm_private_batches(gen, K, batch, seq, vocab)
    open_b = lm_open_batch(gen, n_open or batch, seq, vocab)
    if extras_fn is not None:
        ex = extras_fn(batch, gen)
        private.update({k: v[None].expand((K,) + tuple(v.shape))
                        for k, v in ex.items()})
        open_b.update(ex)
    return FederatedLMTask(x_clients=private, open_x=open_b)


def lm_private_batches(gen: torch.Generator, n_clients: int, batch: int,
                       seq: int, vocab: int) -> dict:
    """Per-client private token batches: sequences of ``n_clients``
    domains, stably sorted by domain and dealt in order (domain d <->
    client d, structurally non-IID)."""
    toks, dom = synthetic.make_token_lm(gen, n_clients * batch, seq, vocab,
                                        n_domains=n_clients)
    order = torch.argsort(dom, stable=True)
    return {"tokens": toks[order].reshape(n_clients, batch, seq)}


def lm_open_batch(gen: torch.Generator, batch: int, seq: int,
                  vocab: int) -> dict:
    """The shared open set: ``batch`` sequences of 7 domains."""
    toks, _ = synthetic.make_token_lm(gen, batch, seq, vocab, n_domains=7)
    return {"tokens": toks}
