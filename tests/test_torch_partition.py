"""The port's Dirichlet and 9:1 partitions, the Reuters and foreign-image
stand-ins, the attacks and the learning-rate schedules against the
reference.

The partitions' numpy cores are the reference's arithmetic: given the
integer the reference draws from its key, they return its indices exactly.
Draws from a ``torch.Generator`` (the partitions' seeds, the data, the
attacks' permutations) differ from ``jax.random``'s, so those are held to
the reference's invariants; the poisoning arithmetic and the schedules are
held to the reference's values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jatt
from repro.data import partition as jpart
from repro.optim import schedules as jsched
from repro_torch.core import attacks
from repro_torch.data import partition, synthetic
from repro_torch.data.pipeline import build_image_task
from repro_torch.optim import constant, cosine, linear_warmup

from test_torch_convert import one_intra_op_thread  # noqa: F401

CPU = "cpu"


def _reference_seed(key) -> int:
    """The integer the reference's numpy partitions seed their rng with."""
    return int(jax.random.randint(key, (), 0, 2**31 - 1))


# ----------------------------------------------------------------- partitions --
@pytest.mark.parametrize("K,alpha,n_classes,seed", [
    (3, 0.1, 10, 0), (5, 1.0, 10, 1), (10, 0.5, 46, 2), (4, 100.0, 7, 3)])
def test_dirichlet_core_is_the_references(K, alpha, n_classes, seed):
    key = jax.random.PRNGKey(seed)
    labels = jax.random.randint(key, (600,), 0, n_classes)
    pkey = jax.random.fold_in(key, 1)
    ref = np.asarray(jpart.dirichlet(pkey, labels, K, alpha, n_classes))
    out = partition.dirichlet_np(_reference_seed(pkey), np.asarray(labels), K,
                                 alpha, n_classes)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("K,ratio,seed", [(4, 0.9, 0), (10, 0.9, 1),
                                          (2, 0.75, 2)])
def test_ratio_non_iid_core_is_the_references(K, ratio, seed):
    key = jax.random.PRNGKey(seed)
    labels = jax.random.permutation(key, jnp.arange(1000) % 2)
    pkey = jax.random.fold_in(key, 1)
    ref = np.asarray(jpart.ratio_non_iid(pkey, labels, K, ratio))
    out = partition.ratio_non_iid_np(_reference_seed(pkey),
                                     np.asarray(labels), K, ratio)
    np.testing.assert_array_equal(out, ref)


def test_dirichlet_wrapper_deals_disjoint_equal_stacks():
    gen = torch.Generator().manual_seed(0)
    labels = torch.randint(0, 10, (500,), generator=gen)
    idx = partition.dirichlet(gen, labels, 5, 0.3, 10)
    assert idx.dtype == torch.long and idx.shape[0] == 5
    flat = idx.flatten().tolist()
    assert len(set(flat)) == len(flat) and 0 < idx.shape[1] <= 100
    # the seed comes from the generator: the same stream, the same indices
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    assert torch.equal(partition.dirichlet(g1, labels, 5, 0.3, 10),
                       partition.dirichlet(g2, labels, 5, 0.3, 10))
    # a small alpha skews the labels: most clients miss some classes
    skew = [len(set(labels[r].tolist())) for r in
            partition.dirichlet(gen, labels, 5, 0.05, 10)]
    assert min(skew) < 10


def test_ratio_non_iid_wrapper_ratios():
    gen = torch.Generator().manual_seed(1)
    labels = torch.arange(1000) % 2
    idx = partition.ratio_non_iid(gen, labels, 10, 0.9)
    assert idx.shape == (10, 100)
    assert sorted(idx.flatten().tolist()) == list(range(1000))
    for k, row in enumerate(idx):
        pos = int(labels[row].sum())
        assert pos == (90 if k % 2 == 0 else 10), (k, pos)


# ----------------------------------------------------------------------- data --
def test_make_bow_invariants():
    """Binary bags of at most ``words_per_doc`` words, one topic table per
    call: documents of one class share more words than those of two."""
    gen = torch.Generator().manual_seed(0)
    x, y = synthetic.make_bow(gen, 400, n_classes=4, vocab=300,
                              words_per_doc=20)
    assert x.shape == (400, 300) and x.dtype == torch.float32
    assert y.shape == (400,) and y.dtype == torch.long
    assert set(torch.unique(x).tolist()) == {0.0, 1.0}
    words = x.sum(dim=1)
    assert int(words.min()) >= 1 and int(words.max()) <= 20
    assert set(y.tolist()) == {0, 1, 2, 3}
    overlap = x @ x.T
    same = y[:, None] == y[None, :]
    off = ~torch.eye(400, dtype=torch.bool)
    assert overlap[same & off].mean() > 3 * overlap[~same].mean()
    x2, y2 = synthetic.make_bow(torch.Generator().manual_seed(0), 400, 4, 300,
                                20)
    assert torch.equal(x, x2) and torch.equal(y, y2)


def test_log_gamma_draws_have_the_gamma_mean():
    """The Dirichlet's Gamma(0.05) draws: E[X] = 0.05, and most of the
    mass in a few of them (a sparse topic): numpy's ``gamma(0.05)`` puts
    0.79 of it in the largest 5% of 200,000 draws."""
    g = synthetic._log_gamma_draws(torch.Generator().manual_seed(3), 0.05,
                                   (200_000,)).exp()
    assert abs(float(g.mean()) - 0.05) < 0.005
    top = g.sort(descending=True).values
    assert 0.75 < float(top[:10_000].sum() / top.sum()) < 0.83


def test_make_fashion_noise_is_a_foreign_family():
    """Images of the template seed 777 (not the digits' 1234) with a +-0.3
    texture on top: each is nearer its own class's foreign template than
    the digits' one."""
    gen = torch.Generator().manual_seed(0)
    x, y = synthetic.make_fashion_noise(gen, 200, hw=16)
    assert x.shape == (200, 16, 16, 1) and x.dtype == torch.float32
    foreign = torch.as_tensor(synthetic._templates(777, 10, 16))
    digits = torch.as_tensor(synthetic._templates(1234, 10, 16))
    img = x[..., 0]
    d_own = ((img - foreign[y]) ** 2).mean()
    d_digit = ((img - digits[y]) ** 2).mean()
    assert d_own < d_digit
    x2, _ = synthetic.make_fashion_noise(torch.Generator().manual_seed(0),
                                         200, hw=16)
    assert torch.equal(x, x2)


def test_build_image_task_dirichlet_and_noisy_open():
    """``dirichlet:<alpha>`` deals disjoint equal stacks; ``noisy_open=N``
    keeps every open sample of the clean task once and adds N others, with
    the private and test sets unchanged."""
    kw = dict(seed=0, K=4, n_private=400, n_open=60, n_test=30, hw=16,
              device=CPU)
    clean = build_image_task(distribution="dirichlet:0.5", **kw)
    noisy = build_image_task(distribution="dirichlet:0.5", noisy_open=25,
                             **kw)
    assert clean.x_clients.shape[0] == 4 and clean.x_clients.shape[1] > 0
    rows = clean.x_clients.reshape(-1, 256)
    assert torch.unique(rows, dim=0).shape[0] == rows.shape[0]
    assert torch.equal(noisy.x_clients, clean.x_clients)
    assert torch.equal(noisy.x_test, clean.x_test)
    assert noisy.open_x.shape == (85, 16, 16, 1)
    o_clean = clean.open_x.reshape(60, -1)
    o_noisy = noisy.open_x.reshape(85, -1)
    hits = (o_noisy[:, None] == o_clean[None]).all(-1)    # (85, 60)
    assert hits.sum(0).tolist() == [1] * 60
    assert int((hits.sum(1) == 0).sum()) == 25


# -------------------------------------------------------------------- attacks --
def test_noisy_label_map_remaps_c_classes_to_distinct_targets():
    gen = torch.Generator().manual_seed(0)
    for C in (1, 3, 10):
        table = attacks.noisy_label_map(gen, 10, C)
        moved = (table != torch.arange(10)).nonzero()[:, 0]
        assert len(moved) <= C
        # the C sources take C distinct targets; the rest stay put
        src_vals = table[table != torch.arange(10)]
        assert len(set(src_vals.tolist())) == len(src_vals)


def test_apply_noisy_labels_per_client():
    """Each client gets its own remap of exactly C sources (some may map to
    themselves); labels of other classes are untouched."""
    gen = torch.Generator().manual_seed(1)
    labels = torch.arange(10).repeat(6, 5)                 # (6, 50)
    noised = attacks.apply_noisy_labels(gen, labels, 10, C=3)
    assert noised.shape == labels.shape
    tables = []
    for k in range(6):
        table = {}
        for a, b in zip(labels[k].tolist(), noised[k].tolist()):
            assert table.setdefault(a, b) == b             # one map a client
        tables.append(tuple(table[c] for c in range(10)))
        changed = [c for c in range(10) if table[c] != c]
        assert len(changed) <= 3
        assert len({table[c] for c in changed}) == len(changed)
    assert len(set(tables)) > 1
    # the reference's rate: about 3 of 10 classes move
    frac = float((noised != labels).float().mean())
    assert 0.1 < frac < 0.45


def test_mix_noisy_open_keeps_every_sample_once():
    gen = torch.Generator().manual_seed(2)
    open_x = torch.arange(30.0).reshape(10, 3)
    noise_x = -torch.arange(1.0, 19.0).reshape(6, 3)
    mixed = attacks.mix_noisy_open(open_x, noise_x, gen)
    assert mixed.shape == (16, 3)
    assert sorted(map(tuple, mixed.tolist())) == sorted(
        map(tuple, torch.cat([open_x, noise_x]).tolist()))
    assert not torch.equal(mixed[:10], open_x)


def test_poison_and_replace_are_the_references():
    """Eq. 19's upload and the replaced upload stack, bitwise; the
    backdoored model's probabilities within 1e-6; the reference's
    ``make_logit_poison`` hands the uploads back unchanged, and so does the
    port's."""
    from repro.models.smallnets import apply_tiny_mlp, init_tiny_mlp
    from repro_torch.models.smallnets import apply_tiny_mlp as t_apply
    from test_torch_convert import to_port
    r = np.random.default_rng(0)
    wx = {"w": r.standard_normal((4, 5)).astype(np.float32),
          "b": r.standard_normal(5).astype(np.float32)}
    wg = {k: r.standard_normal(v.shape).astype(np.float32)
          for k, v in wx.items()}
    for K in (2, 7, 100):
        ref = jatt.poison_fl_upload(wx, wg, K)
        out = attacks.poison_fl_upload(
            {k: torch.from_numpy(v) for k, v in wx.items()},
            {k: torch.from_numpy(v) for k, v in wg.items()}, K)
        for k in wx:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    probs = r.random((3, 8, 10)).astype(np.float32)
    mal = r.random((8, 10)).astype(np.float32)
    for idx in (0, 2):
        np.testing.assert_array_equal(
            attacks.replace_client_probs(torch.from_numpy(probs),
                                         torch.from_numpy(mal), idx).numpy(),
            np.asarray(jatt.replace_client_probs(jnp.asarray(probs),
                                                 jnp.asarray(mal), idx)))
    p, s = init_tiny_mlp(jax.random.PRNGKey(0))
    xo = r.standard_normal((8, 16, 16, 1)).astype(np.float32)
    np.testing.assert_allclose(
        attacks.logit_poison_probs(t_apply, to_port(p), {},
                                   torch.from_numpy(xo)).numpy(),
        np.asarray(jatt.logit_poison_probs(apply_tiny_mlp, p, s,
                                           jnp.asarray(xo))), atol=1e-6)
    t = torch.from_numpy(probs)
    assert attacks.make_logit_poison(t_apply, {}, {})(t, None, None) is t
    assert jatt.make_logit_poison(apply_tiny_mlp, p, s)(probs, None) is probs


# ------------------------------------------------------------------ schedules --
def test_schedules_are_the_references():
    """``constant`` and ``linear_warmup`` bitwise; ``cosine`` within 1e-6
    of each value: the reference's float32 cosine is XLA's and this one is
    numpy's, 1 ulp apart at some angles, which (1 + cos) magnifies where
    cos is near -1 (5.3e-7 at worst here)."""
    for s in range(300):
        assert constant(0.1)(s) == float(jsched.constant(0.1)(s))
        for lr, w in ((0.1, 7), (3e-3, 100), (0.37, 13)):
            assert linear_warmup(lr, w)(s) == float(
                jsched.linear_warmup(lr, w)(s)), (lr, w, s)
    for lr, total, w, floor in ((0.1, 100, 0, 0.0), (3e-3, 1000, 50, 1e-4),
                                (0.5, 37, 5, 0.05)):
        for s in range(0, total + 20, 3):
            np.testing.assert_allclose(
                cosine(lr, total, w, floor)(s),
                float(jsched.cosine(lr, total, w, floor)(s)), rtol=1e-6,
                err_msg=str((lr, total, w, floor, s)))
    assert isinstance(cosine(0.1, 10)(3), float)
