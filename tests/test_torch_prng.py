"""The port's keyed draws (`repro_torch.core.prng`): the hash against a numpy
``uint64`` implementation of the same arithmetic, bit for bit, and the
invariant the cohort plane rides on: a client's rows are a function of
(seed, round, leg, global id) alone, whatever its lane, its slab or K."""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.algorithms import (BatchCtx, DSFLAlgorithm,
                                         active_indices, init_stack,
                                         lane_perms)
from repro_torch.core.client import LocalSpec
from repro_torch.core.engine import open_batch
from repro_torch.core.protocol import DSFLConfig
from repro_torch.models.smallnets import apply_tiny_mlp, init_tiny_mlp
from repro_torch.optim.optimizers import sgd

from test_torch_convert import one_intra_op_thread  # noqa: F401

M = np.uint64(0xFFFFFFFF)


def _np_mix(x):
    x = x ^ (x >> np.uint64(16))
    x = (x * np.uint64(0x7FEB352D)) & M
    x = x ^ (x >> np.uint64(15))
    x = (x * np.uint64(0x846CA68B)) & M
    return x ^ (x >> np.uint64(16))


def _np_absorb(h, w):
    return _np_mix(h ^ ((np.uint64(w) + np.uint64(0x9E3779B9)) & M)
                   if np.isscalar(w) else
                   h ^ ((w.astype(np.uint64) + np.uint64(0x9E3779B9)) & M))


def np_keys(seed, rnd, leg, ids, shape=()):
    """The same hash in numpy uint64 (whose products wrap mod 2**64)."""
    ids = np.asarray(ids, np.uint64)
    n = int(np.prod(shape, dtype=np.int64))
    h = np.uint64(seed & 0xFFFFFFFF)
    for w in ((seed >> 32) & 0xFFFFFFFF, rnd & 0xFFFFFFFF,
              (rnd >> 32) & 0xFFFFFFFF, zlib.crc32(leg.encode())):
        h = _np_absorb(h, np.uint64(w))
    h = _np_absorb(_np_absorb(h, ids & M), ids >> np.uint64(32))
    h = _np_absorb(h[..., None], np.arange(n, dtype=np.uint64))
    hi = _np_absorb(h, np.uint64(0x5BD1E995))
    lo = _np_absorb(hi, np.uint64(0x27D4EB2F))
    out = ((hi & np.uint64(0x7FFFFFFF)) << np.uint64(32)) | lo
    return out.astype(np.int64).reshape(ids.shape + tuple(shape))


@pytest.mark.parametrize("seed,rnd,leg,ids,shape", [
    (0, 0, "update", [0, 1, 2, 3], (2, 5)),
    (7, 123, "distill", [999_999, 5, 2 ** 32 + 3], (17,)),
    (2 ** 40 + 9, 2 ** 33 + 1, "open", 0, (1000,)),
    (3, 1, "init", list(range(64)), ()),
])
def test_hash_equals_numpy_uint64(seed, rnd, leg, ids, shape):
    got = prng.keys(seed, rnd, leg, torch.tensor(ids), shape)
    np.testing.assert_array_equal(got.numpy(),
                                  np_keys(seed, rnd, leg, ids, shape))
    assert bool((got >= 0).all())


def test_keys_spread():
    """63-bit keys: no collisions in 10^5 draws, top bits used, legs and
    rounds differ."""
    k = prng.keys(0, 0, "update", torch.arange(100), (1000,)).reshape(-1)
    assert torch.unique(k).numel() == k.numel()
    assert int(k.max()) > 2 ** 62
    assert not torch.equal(k, prng.keys(0, 1, "update", torch.arange(100),
                                        (1000,)).reshape(-1))
    assert not torch.equal(k, prng.keys(0, 0, "distill", torch.arange(100),
                                        (1000,)).reshape(-1))


def test_epoch_perms_are_permutations():
    """Each client and epoch: distinct items, the head of a permutation cut
    to whole batches; epoch 0's counters are `permutation`'s."""
    ids = torch.tensor([3, 1, 4])
    p = prng.epoch_perms(4, 2, "update", ids, 2, 45, 10)
    assert tuple(p.shape) == (3, 2, 4, 10)
    for row in p.reshape(6, 40):
        assert len(set(row.tolist())) == 40 and int(row.max()) < 45
    full = prng.permutation(4, 2, "update", ids, 45)
    for row in full:
        assert sorted(row.tolist()) == list(range(45))
    assert torch.equal(p[:, 0].reshape(3, 40), full[:, :40])
    assert not torch.equal(p[:, 0], p[:, 1])


@pytest.mark.parametrize("K,S", [(8, 3), (20, 7), (1000, 5)])
def test_rows_do_not_depend_on_lane_slab_or_K(K, S):
    """Client g's permutations: the same row in a dense K stack, in any
    slab that holds g at any lane, and in a sparse gather of that slab."""
    spec = LocalSpec(apply_tiny_mlp, sgd(0.1), 2, 10)
    rng = np.random.default_rng(K)
    ids = np.sort(rng.choice(K, S, replace=False))
    dense = lane_perms(spec, 40, BatchCtx(x=torch.zeros(K, 1)), None, 1, 5,
                       "update")
    for slab in (ids, ids[::-1].copy(), rng.permutation(ids)):
        ctx = BatchCtx(x=torch.zeros(S, 1), cohort=torch.as_tensor(slab),
                       population=K)
        got = lane_perms(spec, 40, ctx, None, 1, 5, "update")
        for lane, g in enumerate(slab):
            assert torch.equal(got[lane], dense[g])
        mask = torch.zeros(S)
        mask[::2] = 1.0
        idx = active_indices(mask, (S + 1) // 2)
        sparse = lane_perms(spec, 40, ctx, None, 1, 5, "update", idx)
        assert torch.equal(sparse, got[idx])


def test_injected_rows_are_gathered_at_the_lanes():
    spec = LocalSpec(apply_tiny_mlp, sgd(0.1), 1, 10)
    inj = torch.arange(4 * 2 * 10).reshape(4, 1, 2, 10) % 20
    ctx = BatchCtx(x=torch.zeros(4, 1))
    idx = torch.tensor([2, 0])
    assert torch.equal(lane_perms(spec, 20, ctx, inj, 0, 0, "update", idx),
                       inj[idx])
    with pytest.raises(ValueError, match="perms must have shape"):
        lane_perms(spec, 20, ctx, inj[:3], 0, 0, "update")


def test_model_inits_are_per_id():
    """Row g of a dense init stack is the model a cohort init of g makes,
    in any company; the generator is seeded from one key."""
    init = lambda g: init_tiny_mlp(g, device="cpu")
    w, _ = init_stack(0, init, range(6), "cpu")
    w2, _ = init_stack(0, init, [5, 2], "cpu")
    for k in w:
        assert torch.equal(w2[k][0], w[k][5]) and torch.equal(w2[k][1], w[k][2])
        assert not torch.equal(w[k][0], w[k][1]) or k.endswith("/b")
    algo = DSFLAlgorithm(apply_tiny_mlp, DSFLConfig(), device="cpu")
    c = algo.init_cohort(0, init, np.array([3, 1]), 6)
    for k in w:
        assert torch.equal(c.params[k][0], w[k][3])
    with pytest.raises(ValueError, match="outside a fleet"):
        algo.init_cohort(0, init, np.array([6]), 6)
    g1 = prng.generator(0, 0, "init", 3, "cpu")
    g2 = prng.generator(0, 0, "init", 3, "cpu")
    assert torch.equal(torch.randn(5, generator=g1),
                       torch.randn(5, generator=g2))


def test_open_batch_is_keyed_on_the_round():
    a, b = open_batch(0, 3, 100, 40, "cpu"), open_batch(0, 3, 100, 40, "cpu")
    assert torch.equal(a, b) and len(set(a.tolist())) == 40
    assert not torch.equal(a, open_batch(0, 4, 100, 40, "cpu"))
    assert not torch.equal(a, open_batch(1, 3, 100, 40, "cpu"))
