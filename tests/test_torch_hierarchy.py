"""Two-level (edge -> server) ERA (`repro_torch.core.hierarchy`) against the
reference's `repro.core.hierarchy`, its contract inside the port (mirroring
the ``hierarchy_*`` tests of tests/test_cohort.py), and DS-FL rounds with
``agg_edges=2`` against the reference's.

Tolerances: ``n_edges=1`` is bitwise the port's flat aggregation; deeper
trees are within rtol 1e-6, atol 1e-7 of it (SA) and rtol 1e-5, atol 1e-6
(ERA, whose softmax / 0.1 scales a difference by up to 10), as the
reference pins its own tree; a zero-weight lane changes no output bit at
any depth.  Against the reference's functions on the same (8, 4, 10)
stacks: atol 1e-6.  The rounds (``tiny_mlp``, K=4, 2 rounds, the
reference's draws injected) to tests/test_torch_round.py's atol 2e-4,
rtol 1e-3."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hierarchy as jh
from repro.core.algorithms import DSFLAlgorithm as JAlgo
from repro.core.engine import FedEngine as JEngine
from repro.core.protocol import DSFLConfig as JConfig
from repro.models.smallnets import apply_tiny_mlp as j_apply_mlp
from repro_torch.core import aggregation as agg
from repro_torch.core.algorithms import DSFLAlgorithm
from repro_torch.core.engine import FedEngine
from repro_torch.core.hierarchy import (edge_shards, hierarchical_weighted_era,
                                        hierarchical_weighted_sa)
from repro_torch.core.protocol import DSFLConfig
from repro_torch.models.smallnets import apply_tiny_mlp, init_tiny_mlp

from test_torch_convert import (assert_state_close, numpy_models, numpy_task,
                                reference_run_draws)

from test_torch_convert import one_intra_op_thread  # noqa: F401

ATOL_REF = 1e-6
ATOL, RTOL = 2e-4, 1e-3
K, ROUNDS, N_K, N_OPEN = 4, 2, 80, 160
HP = dict(rounds=ROUNDS, local_epochs=1, distill_epochs=1, batch_size=40,
          open_batch=80)


def _prob_stack(seed, k=8, n=4, c=10):
    logits = np.random.default_rng(seed).normal(size=(k, n, c)) * 3
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def test_edge_shards_match_reference():
    for k, n in [(8, 1), (8, 3), (7, 7), (10, 4), (100, 4), (5, 2)]:
        assert edge_shards(k, n) == jh.edge_shards(k, n)
    for k, n in [(4, 5), (4, 0)]:
        with pytest.raises(ValueError):
            edge_shards(k, n)


def test_hierarchy_single_edge_is_bitwise_flat():
    p = _prob_stack(0)
    w = np.array([0.0, 2.0, 1.0, 0.0, 3.0, 1.0, 0.5, 0.0], np.float32)
    assert torch.equal(hierarchical_weighted_sa(_t(p), _t(w), n_edges=1),
                       agg.weighted_sa(_t(p), _t(w)))
    assert torch.equal(hierarchical_weighted_era(_t(p), _t(w), 0.1, n_edges=1),
                       agg.weighted_era(_t(p), _t(w), 0.1))


@pytest.mark.parametrize("n_edges", [2, 3, 4, 8])
def test_hierarchy_depth_tolerance_contract(n_edges):
    p = _t(_prob_stack(1))
    w_np = np.random.default_rng(1).random(8).astype(np.float32)
    w = _t(w_np)
    sa = hierarchical_weighted_sa(p, w, n_edges=n_edges)
    era = hierarchical_weighted_era(p, w, 0.1, n_edges=n_edges)
    torch.testing.assert_close(sa, agg.weighted_sa(p, w), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(era, agg.weighted_era(p, w, 0.1), rtol=1e-5,
                               atol=1e-6)
    jp, jw = jnp.asarray(p.numpy()), jnp.asarray(w_np)
    np.testing.assert_allclose(
        sa.numpy(), np.asarray(jh.hierarchical_weighted_sa(jp, jw, n_edges)),
        rtol=0, atol=ATOL_REF)
    np.testing.assert_allclose(
        era.numpy(),
        np.asarray(jh.hierarchical_weighted_era(jp, jw, 0.1, n_edges)),
        rtol=0, atol=ATOL_REF)


@pytest.mark.parametrize("n_edges", [1, 2, 3, 8])
def test_hierarchy_zero_weight_lanes_exact_at_any_depth(n_edges):
    p = _t(_prob_stack(2))
    w = torch.tensor([0.0, 2.0, 0.0, 1.0, 3.0, 0.0, 0.5, 1.0])
    garbage = p.clone()
    garbage[[0, 2, 5]] = 123.456
    for use_kernel in (False, True):
        for fn in (lambda x: hierarchical_weighted_sa(
                       x, w, n_edges=n_edges, use_kernel=use_kernel),
                   lambda x: hierarchical_weighted_era(
                       x, w, 0.1, n_edges=n_edges, use_kernel=use_kernel)):
            assert torch.equal(fn(p), fn(garbage))


def test_hierarchy_kernel_route_matches_einsum():
    """The kernel route (K2's weighted mean per edge; its plain version on
    the CPU) against the einsum tree, and at one edge the flat kernel
    route exactly."""
    p = _t(_prob_stack(3))
    w = _t(np.random.default_rng(3).random(8).astype(np.float32))
    assert torch.equal(
        hierarchical_weighted_sa(p, w, n_edges=1, use_kernel=True),
        agg.weighted_sa(p, w, use_kernel=True))
    torch.testing.assert_close(
        hierarchical_weighted_sa(p, w, n_edges=4, use_kernel=True),
        agg.weighted_sa(p, w), rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def task():
    return numpy_task(2, K, N_K, N_OPEN, 40)


@pytest.mark.parametrize("plan", ["dense", "masked", "sparse"])
def test_edge_tree_round_matches_reference(task, plan):
    """Two rounds of weighted ERA through a 2-edge tree: dense (weights the
    clients' reliabilities), masked, and participation-sparse."""
    ref_task, port_task = task
    init = functools.partial(init_tiny_mlp, device="cpu")
    port, ref = numpy_models(init, K, 3)
    mask = np.array([[1, 1, 0, 1], [0, 1, 1, 0]], np.float32)
    kw = {"active_budget": 3} if plan == "sparse" else {}
    jalgo = JAlgo(j_apply_mlp, JConfig(**HP, aggregation="weighted_era"),
                  use_kernel=True, agg_edges=2)
    jeng = JEngine(jalgo)
    jstate = jeng.run(jalgo.init_from(*ref), ref_task, ctx_plan=(
        None if plan == "dense" else {"mask": jnp.asarray(mask)}), **kw)
    algo = DSFLAlgorithm(apply_tiny_mlp,
                         DSFLConfig(**HP, aggregation="weighted_era"),
                         use_kernel=True, agg_edges=2, device="cpu")
    eng = FedEngine(algo)
    draws = reference_run_draws(JConfig(**HP), K, N_K, N_OPEN, ROUNDS)
    state = eng.run(algo.init_from(*port), port_task, draws=draws, ctx_plan=(
        None if plan == "dense" else {"mask": torch.tensor(mask)}), **kw)
    assert_state_close(state, jax.device_get(jstate), atol=ATOL, rtol=RTOL)
    for a, b in zip(eng.history, jeng.history):
        for key in b:
            np.testing.assert_allclose(a[key], b[key], atol=ATOL, rtol=RTOL,
                                       err_msg=key)
