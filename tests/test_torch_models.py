"""The port's small models and client loops against the reference, from
converted reference parameters and, for the loops, the reference's own
epoch permutations."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jc
from repro.core.losses import xent_int_labels as j_xent
from repro.models import smallnets as jsn
from repro.optim import optimizers as jopt
from repro_torch.core import client as tc
from repro_torch.core.losses import xent_int_labels as t_xent
from repro_torch.models import smallnets as tsn
from repro_torch.optim import optimizers as topt

from test_torch_convert import (_perm_stack, assert_flat_close, flat_ref,
                                to_port)

from test_torch_convert import one_intra_op_thread  # noqa: F401

CPU = "cpu"
NARROW = dict(image_hw=16, widths=(8, 16), fc=32)


def _images(seed, n, hw):
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 1)).astype(np.float32)


# --------------------------------------------------------------------- models --
@pytest.mark.parametrize("train", [True, False])
def test_mnist_cnn_full_width_matches_reference(rng, train):
    p, s = jsn.init_mnist_cnn(rng)                 # paper width, 28x28
    # non-trivial running stats, so eval mode is not the identity BN
    s = jax.tree.map(lambda a: a + 0.1, s)
    x = _images(0, 8, 28)
    logits, ns = jsn.apply_mnist_cnn(p, s, jnp.asarray(x), train)
    tp, ts = to_port(p), to_port(s)
    tlogits, tns = tsn.apply_mnist_cnn(tp, ts, torch.from_numpy(x), train)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(logits),
                               atol=1e-4, rtol=1e-4)
    assert_flat_close(tns, ns, atol=1e-5, rtol=1e-5)

    y = np.arange(8) % 10
    g = jax.grad(lambda p_: j_xent(jsn.apply_mnist_cnn(p_, s, jnp.asarray(x),
                                                       train)[0],
                                   jnp.asarray(y)))(p)
    tg = torch.func.grad(lambda p_: t_xent(tsn.apply_mnist_cnn(
        p_, ts, torch.from_numpy(x), train)[0], torch.from_numpy(y)))(tp)
    assert_flat_close(tg, g, atol=1e-5, rtol=1e-4)


def test_mnist_cnn_parameter_count_and_names(rng):
    p, s = tsn.init_mnist_cnn(torch.Generator().manual_seed(0), device=CPU)
    assert tsn.param_count(p) == 582_218
    assert tsn.param_count(p, s) == 582_410
    jp, js = jsn.init_mnist_cnn(rng)
    ref = {**flat_ref(jp), **{f"state/{k}": v for k, v in flat_ref(js).items()}}
    port = {**p, **{f"state/{k}": v for k, v in s.items()}}
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert tuple(port[k].shape) == ref[k].shape, k
    # He-normal scale: the conv/dense weights' spread is the reference's
    for k in ("c2/w", "d1/w"):
        assert abs(float(port[k].std()) / float(ref[k].std()) - 1) < 0.05, k


def test_tiny_mlp_matches_reference(rng):
    p, s = jsn.init_tiny_mlp(rng)
    x = _images(1, 5, 16)
    logits, _ = jsn.apply_tiny_mlp(p, s, jnp.asarray(x), True)
    tlogits, tns = tsn.apply_tiny_mlp(to_port(p), {}, torch.from_numpy(x), True)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(logits), atol=1e-5)
    assert tns == {}
    tp, _ = tsn.make_smallnet("tiny_mlp", device=CPU).init(
        torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == {
        k: v.shape for k, v in flat_ref(p).items()}


# --------------------------------------------------------------- client loops --
K = 2


@pytest.fixture(scope="module")
def stack():
    key = jax.random.PRNGKey(3)
    init = functools.partial(jsn.init_mnist_cnn, **NARROW)
    wk, sk = jax.vmap(init)(jax.random.split(key, K))
    r = np.random.default_rng(4)
    x = r.standard_normal((K, 50, 16, 16, 1)).astype(np.float32)
    y = r.integers(0, 10, (K, 50)).astype(np.int32)
    xo = r.standard_normal((30, 16, 16, 1)).astype(np.float32)
    e = np.exp(r.standard_normal((30, 10)) * 2)
    teacher = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return wk, sk, x, y, xo, teacher


def _perms(key, epochs, n, bs):
    return torch.as_tensor(np.stack(
        [_perm_stack(k, epochs, n, bs) for k in jax.random.split(key, K)]
    ).astype(np.int64))


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_local_update_matches_reference(stack, opt):
    """Batch size 20 over 50 items: 2 batches per epoch, tail dropped."""
    wk, sk, x, y, _, _ = stack
    jspec = jc.LocalSpec(jsn.apply_mnist_cnn, jopt.make(opt, 0.1), 2, 20)
    tspec = tc.LocalSpec(tsn.apply_mnist_cnn, topt.make(opt, 0.1), 2, 20)
    key = jax.random.PRNGKey(9)
    ok = jax.vmap(jspec.opt.init)(wk)
    jout = jax.vmap(lambda w, s, o, xk, yk, rk: jc.local_update(
        jspec, w, s, o, xk, yk, rk))(wk, sk, ok, jnp.asarray(x),
                                     jnp.asarray(y), jax.random.split(key, K))
    tout = tc.local_update(tspec, to_port(wk), to_port(sk), to_port(ok),
                           torch.from_numpy(x), torch.from_numpy(y),
                           perms=_perms(key, 2, 50, 20))
    for t_tree, j_tree in zip(tout[:3], jout[:3]):
        assert_flat_close(t_tree, j_tree, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               atol=1e-5)


def test_local_distill_matches_reference_with_batch_clamp(stack):
    """batch_size 64 > 30 open items clamps to one batch of 30."""
    wk, sk, _, _, xo, teacher = stack
    jspec = jc.LocalSpec(jsn.apply_mnist_cnn, jopt.sgd(0.1), 2, 64)
    tspec = tc.LocalSpec(tsn.apply_mnist_cnn, topt.sgd(0.1), 2, 64)
    key = jax.random.PRNGKey(11)
    jout = jax.vmap(lambda w, s, rk: jc.local_distill(
        jspec, w, s, (), jnp.asarray(xo), jnp.asarray(teacher), rk))(
        wk, sk, jax.random.split(key, K))
    perms = _perms(key, 2, 30, 30)
    assert tuple(perms.shape) == (K, 2, 1, 30)
    tout = tc.local_distill(tspec, to_port(wk), to_port(sk), {},
                            torch.from_numpy(xo), torch.from_numpy(teacher),
                            perms=perms)
    for t_tree, j_tree in zip(tout[:2], jout[:2]):
        assert_flat_close(t_tree, j_tree, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               atol=1e-5)
    with pytest.raises(ValueError, match="perms must have shape"):
        tc.local_distill(tspec, to_port(wk), to_port(sk), {},
                         torch.from_numpy(xo), torch.from_numpy(teacher),
                         perms=perms[:, :1])


def test_drawn_perms_are_clamped_permutations(stack):
    """Keyed draws (`perms_for` without injected rows): each client and
    epoch a permutation cut to whole batches, the batch clamped to n; a
    loop without perms raises."""
    wk, sk, x, y, _, _ = stack
    spec = tc.LocalSpec(tsn.apply_mnist_cnn, topt.sgd(0.1), 3, 20)
    ids = torch.arange(K)
    p = tc.perms_for(spec, 50, ids, seed=0, rnd=0, leg="update")
    assert tuple(p.shape) == (K, 3, 2, 20)
    assert all(len(set(row.tolist())) == 40 for row in p.reshape(K * 3, 40))
    assert tuple(tc.perms_for(spec, 7, ids, rnd=1).shape) == (K, 3, 1, 7)
    n = x.shape[1]
    out = tc.local_update(spec, to_port(wk), to_port(sk), {},
                          torch.from_numpy(x), torch.from_numpy(y),
                          tc.perms_for(spec, n, ids, seed=1, rnd=0))
    assert torch.isfinite(out[3]).all()
    with pytest.raises(ValueError, match="precomputed perms"):
        tc.local_update(spec, to_port(wk), to_port(sk), {},
                        torch.from_numpy(x), torch.from_numpy(y), None)


@pytest.mark.parametrize("bs", [0, 7, 30, 100])
def test_predict_probs_matches_reference_plain_and_chunked(stack, bs):
    wk, sk, _, _, xo, _ = stack
    w = jax.tree.map(lambda a: a[0], wk)
    s = jax.tree.map(lambda a: a[0], sk)
    ref = jc.predict_probs(jsn.apply_mnist_cnn, w, s, jnp.asarray(xo),
                           batch_size=bs)
    out = tc.predict_probs(tsn.apply_mnist_cnn, to_port(w), to_port(s),
                           torch.from_numpy(xo), batch_size=bs)
    assert out.shape == (30, 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
