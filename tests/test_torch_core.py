"""The port's losses, aggregation operators and optimizers against the
reference on the same numpy inputs (fp32, atol 1e-6; 1e-7 for one
optimizer step)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import losses as jl
from repro.optim import optimizers as jopt
from repro_torch.core import aggregation as tagg
from repro_torch.core import losses as tl
from repro_torch.optim import optimizers as topt

from test_torch_convert import assert_flat_close
from test_torch_convert import one_intra_op_thread  # noqa: F401

ATOL = 1e-6


def _r(seed):
    return np.random.default_rng(seed)


def _probs(seed, shape, scale=2.0):
    x = _r(seed).standard_normal(shape).astype(np.float32) * scale
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port.detach()), np.asarray(ref),
                               atol=atol, rtol=0)


T = torch.from_numpy
J = jnp.asarray


# --------------------------------------------------------------------- losses --
def test_losses_match_reference():
    r = _r(0)
    logits = (r.standard_normal((3, 7, 10)) * 3).astype(np.float32)
    labels = r.integers(0, 10, (3, 7)).astype(np.int32)
    soft = _probs(1, (3, 7, 10))
    mask = (r.uniform(size=(3, 7)) > 0.4).astype(np.float32)
    _close(tl.log_softmax(T(logits)), jl.log_softmax(J(logits)))
    for m in (None, mask):
        mj, mt = (None, None) if m is None else (J(m), T(m))
        _close(tl.softmax_xent(T(logits), T(soft), mt),
               jl.softmax_xent(J(logits), J(soft), mj))
        _close(tl.xent_int_labels(T(logits), T(labels), mt),
               jl.xent_int_labels(J(logits), J(labels), mj))
        for use_kernel in (False, True):
            _close(tl.distill_xent(T(logits), T(soft), mt, use_kernel),
                   jl.distill_xent(J(logits), J(soft), mj, use_kernel))
    v, i = jax.lax.top_k(J(soft), 3)
    _close(tl.topk_distill_xent(T(logits), T(np.array(v)),
                                T(np.array(i))),
           jl.topk_distill_xent(J(logits), v, i))
    _close(tl.entropy(T(soft)), jl.entropy(J(soft)))
    _close(tl.accuracy(T(logits), T(labels)), jl.accuracy(J(logits), J(labels)))
    _close(tl.pinned_mean(T(mask), T(mask)), jl.pinned_mean(J(mask), J(mask)))


# ---------------------------------------------------------------- aggregation --
@pytest.mark.parametrize("use_kernel", [False, True])
def test_aggregation_matches_reference(use_kernel):
    p = _probs(2, (4, 13, 10))
    w = np.array([1.0, 2.0, 0.0, 1.0], np.float32)
    _close(tagg.sa(T(p)), jagg.sa(J(p)))
    _close(tagg.era(T(p), 0.1, use_kernel), jagg.era(J(p), 0.1, use_kernel))
    _close(tagg.weighted_sa(T(p), T(w), use_kernel),
           jagg.weighted_sa(J(p), J(w), use_kernel))
    _close(tagg.weighted_era(T(p), T(w), 0.1, use_kernel),
           jagg.weighted_era(J(p), J(w), 0.1, use_kernel))
    for method in ("sa", "era", "weighted_era"):
        _close(tagg.aggregate(T(p), method, 0.1, weights=T(w),
                              use_kernel=use_kernel),
               jagg.aggregate(J(p), method, 0.1, weights=J(w),
                              use_kernel=use_kernel))
    for method in ("sa", "era"):
        _close(tagg.aggregate(T(p), method, 0.1, use_kernel=use_kernel),
               jagg.aggregate(J(p), method, 0.1, use_kernel=use_kernel))
    # the 4-D (LLM-shaped) stack keeps the einsum path under use_kernel
    p4 = _probs(3, (3, 2, 4, 8))
    _close(tagg.weighted_era(T(p4), torch.ones(3), 0.1, use_kernel),
           jagg.weighted_era(J(p4), jnp.ones(3), 0.1))


def test_weight_rules_match_reference():
    _close(tagg._normalize_weights(torch.zeros(4)),
           jagg._normalize_weights(jnp.zeros(4)))
    _close(tagg._normalize_weights(T(np.array([1., 3., 0., 4.], np.float32))),
           jagg._normalize_weights(J(np.array([1., 3., 0., 4.], np.float32))))
    p = _probs(4, (4, 8, 10))
    _close(tagg.weighted_era(T(p), torch.zeros(4), 0.1), jagg.era(J(p), 0.1),
           atol=1e-5)
    mask = np.array([1, 0, 1, 1], np.float32)
    stale = np.array([0, 3, 2, 1], np.float32)
    base = np.array([0.5, 2.0, 1.0, 0.25], np.float32)
    for kw_t, kw_j in (({}, {}),
                       ({"staleness": T(stale), "decay": 0.5},
                        {"staleness": J(stale), "decay": 0.5}),
                       ({"staleness": T(stale), "decay": 0.5, "base": T(base)},
                        {"staleness": J(stale), "decay": 0.5, "base": J(base)}),
                       ({"staleness": T(stale), "decay": 0.0},
                        {"staleness": J(stale), "decay": 0.0})):
        _close(tagg.participation_weights(T(mask), **kw_t),
               jagg.participation_weights(J(mask), **kw_j))
    assert float(tagg.participation_weights(T(mask))[1]) == 0.0
    with pytest.raises(ValueError):
        tagg.aggregate(T(p), "weighted_era")


def test_topk_helpers_match_reference():
    """Inputs with no ties: lax.top_k and torch.topk may order ties
    differently."""
    r = _r(5)
    p = _probs(5, (3, 6, 20), scale=3.0) + r.uniform(0, 1e-4, (3, 6, 20)
                                                      ).astype(np.float32)
    k = 4
    vt, it = tagg.topk_compress(T(p), k)
    vj, ij = jagg.topk_compress(J(p), k)
    _close(vt, vj)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(tagg.topk_decompress(vt, it, 20),
           jagg.topk_decompress(vj, ij, 20))
    _close(tagg.era_topk(vt, it, 20, 0.1), jagg.era_topk(vj, ij, 20, 0.1))
    ot, oit = tagg.era_topk(vt, it, 20, 0.1, k_out=3)
    oj, oij = jagg.era_topk(vj, ij, 20, 0.1, k_out=3)
    _close(ot, oj)
    np.testing.assert_array_equal(oit.numpy(), np.asarray(oij))


# ----------------------------------------------------------------- optimizers --
@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_one_optimizer_step_matches_reference(name):
    r = _r(6)
    params = {"a": {"w": r.standard_normal((3, 4)).astype(np.float32)},
              "b": r.standard_normal((5,)).astype(np.float32)}
    grads = jax.tree.map(lambda a: r.standard_normal(a.shape).astype(np.float32),
                         params)
    lr = 0.1 if name != "adam" else 1e-3
    jo, to = jopt.make(name, lr), topt.make(name, lr)
    jp = jax.tree.map(J, params)
    jstate = jo.init(jp)
    from repro_torch import convert
    tp = convert.from_numpy_tree(params, "cpu")
    tstate = to.init(tp)
    for step in range(2):      # two steps: the state carries over
        jp, jstate = jo.update(jax.tree.map(J, grads), jp, jstate, step)
        tp, tstate = to.update(convert.from_numpy_tree(grads, "cpu"), tp,
                               tstate, step)
        assert_flat_close(tp, jp, atol=1e-7)
        assert_flat_close(tstate, jstate, atol=1e-7)
    assert topt._lr_at(lambda s: 0.5 * s, 4) == jopt._lr_at(lambda s: 0.5 * s,
                                                            4)
