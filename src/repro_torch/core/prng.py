"""Keyed, counter-based draws: every random choice of a round is a pure
function of ``(seed, round, leg, global client id, counter)``.

This is the port's own design, in place of the reference's
``split(rng, K)`` rows (``repro/core/prng.py``'s ``split_take``).  A
client's draws do not depend on its lane, its slab or the fleet size K, so
a sparse round draws only its m rows, a cohort slab draws exactly what the
dense round draws for the same ids, a checkpoint needs no generator state
and a run can be cut into chunks at any round.

The hash works on 32-bit words held in int64 tensors, so it gives the same
bits on the CPU and on the card: every shift is of a non-negative value
below 2**32 (where torch's arithmetic ``>>`` is the logical one), and every
multiply by a 32-bit constant is split into 16-bit halves so that no
product reaches 2**63.  ``tests/test_torch_prng.py`` pins it against a
numpy ``uint64`` implementation of the same arithmetic.

Permutations are ``torch.sort(keys, stable=True).indices``; model inits
take a ``torch.Generator`` seeded with one key.
"""
from __future__ import annotations

import zlib

import torch

M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_C1, _C2 = 0x7FEB352D, 0x846CA68B       # the lowbias32 finaliser's constants


def leg_code(leg: str) -> int:
    """A leg's name as a 32-bit word (CRC-32, stable across runs)."""
    return zlib.crc32(leg.encode())


def _mul32(x, c: int):
    """``x * c mod 2**32`` for ``0 <= x < 2**32`` (a tensor or an int),
    every product below 2**49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def _mix(x):
    """lowbias32: a bijection of 32-bit words with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, _C1)
    x = x ^ (x >> 15)
    x = _mul32(x, _C2)
    return x ^ (x >> 16)


def _absorb(h, word):
    """Mix one 32-bit word into the state h."""
    return _mix(h ^ ((word + _GOLDEN) & M32))


def keys(seed: int, rnd: int, leg: str, ids, shape=(), device=None
         ) -> torch.Tensor:
    """int64 keys in ``[0, 2**63)`` of shape ``ids.shape + shape``: element
    ``(i, c)`` hashes (seed, round, leg, ids[i], c), where c is the flat
    index into ``shape``.  Computed on ``ids``' device (or ``device`` when
    ``ids`` is not a tensor); identical bits on every device."""
    ids = torch.as_tensor(ids, dtype=torch.int64, device=device)
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    h = seed & M32            # the prefix words, hashed as Python ints
    for w in ((seed >> 32) & M32, rnd & M32, (rnd >> 32) & M32, leg_code(leg)):
        h = _absorb(h, w)
    h = _absorb(_absorb(h, ids & M32), ids >> 32)
    c = torch.arange(n, dtype=torch.int64, device=ids.device)
    h = _absorb(h.reshape(h.shape + (1,)), c)              # (..., n)
    hi = _absorb(h, 0x5BD1E995)
    lo = _absorb(hi, 0x27D4EB2F)
    return (((hi & 0x7FFFFFFF) << 32) | lo).reshape(ids.shape + shape)


def permutation(seed: int, rnd: int, leg: str, ids, n: int,
                device=None) -> torch.Tensor:
    """(*ids.shape, n) int64: a permutation of ``range(n)`` per id."""
    return torch.sort(keys(seed, rnd, leg, ids, (n,), device), dim=-1,
                      stable=True).indices


def epoch_perms(seed: int, rnd: int, leg: str, ids, epochs: int, n: int,
                batch_size: int) -> torch.Tensor:
    """(L, epochs, nb, bs) minibatch indices for the L clients ``ids``: an
    independent permutation of ``range(n)`` per client and epoch, cut to
    ``nb = n // batch_size`` whole batches (the tail is dropped, as the
    reference's ``_epoch_perm`` drops it)."""
    nb = n // batch_size
    ids = torch.as_tensor(ids, dtype=torch.int64)
    p = torch.sort(keys(seed, rnd, leg, ids, (epochs, n)), dim=-1,
                   stable=True).indices
    return p[..., :nb * batch_size].reshape(ids.shape[0], epochs, nb,
                                            batch_size)


def generator(seed: int, rnd: int, leg: str, gid: int, device
              ) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with the key of (seed,
    round, leg, gid); the key is computed on the CPU, so every device seeds
    its generator with the same number."""
    k = int(keys(seed, rnd, leg, torch.tensor(gid)))
    return torch.Generator(device=device).manual_seed(k)
