"""The participation-sparse round plane (``FedEngine.run(active_budget=m)``)
against the reference's, and against the port's own dense masked round.

Against the reference: 2 rounds of DS-FL on the narrow 16x16 MNIST CNN,
K=4, masks of 2 participants and ``active_budget=2``, the reference's own
draws injected, every RoundState leaf and history float to the tolerances
of tests/test_torch_round.py (atol 2e-4, rtol 1e-3).

Inside the port, sparse against dense masked from the same state and draws:
- always bitwise: absent clients' leaves, the aggregation weights of SA and
  ERA (they depend on the mask alone) and the lanes `scatter_zeros` leaves;
- ``tiny_mlp`` (no convolution): every leaf and metric bitwise;
- the CNN: the participants' leaves within SPARSE_CNN_ATOL.  The m-lane
  convolutions may take another algorithm than the K-lane ones (oneDNN on
  the CPU, cuDNN on the card), so the gradients part in the last bits; the
  largest difference seen after two rounds on the CPU is 1.7e-6 (weighted
  ERA; SA 8.3e-7, ERA 1.3e-6).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.algorithms import DSFLAlgorithm as JAlgo
from repro.core.algorithms import active_indices as j_active_indices
from repro.core.engine import FedEngine as JEngine
from repro.core.protocol import DSFLConfig as JConfig
from repro.models.smallnets import apply_mnist_cnn as j_apply_cnn
from repro_torch.core.algorithms import (DSFLAlgorithm, active_indices,
                                         gather_clients, scatter_clients,
                                         scatter_zeros)
from repro_torch.core.engine import FedEngine
from repro_torch.core.protocol import DSFLConfig
from repro_torch.models.smallnets import (apply_mnist_cnn, apply_tiny_mlp,
                                          init_mnist_cnn, init_tiny_mlp)

from test_torch_convert import (assert_state_close, convert, numpy_models,
                                numpy_task, reference_run_draws)

from test_torch_convert import one_intra_op_thread  # noqa: F401

K, ROUNDS, N_K, N_OPEN = 4, 2, 80, 160
ATOL, RTOL = 2e-4, 1e-3
SPARSE_CNN_ATOL = 1e-5
HP = dict(rounds=ROUNDS, local_epochs=1, distill_epochs=1, batch_size=40,
          open_batch=80)
MASK = np.array([[1, 0, 1, 0], [0, 1, 1, 0]], np.float32)
INITS = {"cnn": functools.partial(init_mnist_cnn, image_hw=16, widths=(8, 16),
                                  fc=32, device="cpu"),
         "mlp": functools.partial(init_tiny_mlp, device="cpu")}
APPLY = {"cnn": apply_mnist_cnn, "mlp": apply_tiny_mlp}


@pytest.fixture(scope="module")
def task():
    return numpy_task(0, K, N_K, N_OPEN, 80)


@pytest.fixture(scope="module")
def draws():
    return reference_run_draws(JConfig(**HP), K, N_K, N_OPEN, ROUNDS)


def _port_run(task, model, aggregation, budget, mask=MASK, draws=None):
    (_, port_task), (port, _) = task, numpy_models(INITS[model], K, 1)
    algo = DSFLAlgorithm(APPLY[model],
                         DSFLConfig(**HP, aggregation=aggregation),
                         use_kernel=True, device="cpu")
    eng = FedEngine(algo)
    state = eng.run(algo.init_from(*port), port_task, draws=draws,
                    ctx_plan={"mask": torch.tensor(mask)},
                    active_budget=budget)
    return algo.init_from(*port), state, eng


@pytest.mark.parametrize("aggregation", ["sa", "era", "weighted_era"])
def test_sparse_round_matches_reference(task, draws, aggregation):
    ref_task, port_task = task
    _, (wk, sk, wg, sg) = numpy_models(INITS["cnn"], K, 1)
    jalgo = JAlgo(j_apply_cnn, JConfig(**HP, aggregation=aggregation),
                  use_kernel=True)
    jeng = JEngine(jalgo)
    jstate = jeng.run(jalgo.init_from(wk, sk, wg, sg), ref_task,
                      ctx_plan={"mask": jnp.asarray(MASK)}, active_budget=2)
    _, state, eng = _port_run(task, "cnn", aggregation, 2, draws=draws)
    assert_state_close(state, jax.device_get(jstate), atol=ATOL, rtol=RTOL)
    for a, b in zip(eng.history, jeng.history):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_allclose(a[key], b[key], atol=ATOL, rtol=RTOL,
                                       err_msg=key)
    np.testing.assert_allclose(eng.last_metrics["agg_weights"].numpy(),
                               np.asarray(jeng.last_metrics["agg_weights"]),
                               atol=ATOL, rtol=RTOL)


def _leaves(state):
    return {f"{part}.{f}.{k}": v for part, t in
            convert.round_state_to_numpy(state).items()
            for f, tree in t.items()
            for k, v in convert.flatten_tree(tree).items()}


@pytest.mark.parametrize("model", ["mlp", "cnn"])
@pytest.mark.parametrize("aggregation", ["sa", "era", "weighted_era"])
def test_sparse_equals_dense_masked_in_port(task, draws, model, aggregation):
    """Same state, same draws: budget 2 (exactly the participants) and, for
    the MLP, 3 (one padding lane) against the dense masked round."""
    init, dense, de = _port_run(task, model, aggregation, None, draws=draws)
    ref, want = _leaves(init), _leaves(dense)
    for budget in ((2, 3) if model == "mlp" else (2,)):
        _, sparse, se = _port_run(task, model, aggregation, budget,
                                  draws=draws)
        got = _leaves(sparse)
        for name, v in want.items():
            if name.startswith("clients."):
                # client 3 sat out both rounds: bitwise its initial state
                np.testing.assert_array_equal(got[name][3], ref[name][3])
                np.testing.assert_array_equal(got[name][3], v[3])
            if model == "mlp":
                np.testing.assert_array_equal(got[name], v, err_msg=name)
            else:
                np.testing.assert_allclose(got[name], v, rtol=0,
                                           atol=SPARSE_CNN_ATOL, err_msg=name)
        aw_s = se.last_metrics["agg_weights"]
        aw_d = de.last_metrics["agg_weights"]
        if model == "mlp" or aggregation != "weighted_era":
            assert torch.equal(aw_s, aw_d)
        assert float(aw_s[0]) == float(aw_s[3]) == 0.0
        for a, b in zip(se.history, de.history):
            for key in b:
                if model == "mlp":
                    assert a[key] == b[key], key
                else:
                    assert abs(a[key] - b[key]) <= 1e-5 * max(1, abs(b[key]))


@pytest.mark.parametrize("seed", range(6))
def test_sparse_plane_helpers(seed):
    """`active_indices` is the reference's on random masks; gathered lanes
    scatter back in place; `scatter_zeros` leaves exact zeros."""
    rng = np.random.default_rng(seed)
    K_ = int(rng.integers(1, 12))
    mask = (rng.random(K_) < 0.5).astype(np.float32)
    budget = int(rng.integers(max(1, int(mask.sum())), K_ + 1))
    idx = active_indices(torch.tensor(mask), budget)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(j_active_indices(jnp.asarray(mask), budget)))
    assert sorted(idx.tolist()) == sorted(set(idx.tolist()))
    tree = {"a": torch.tensor(rng.random((K_, 3)), dtype=torch.float32),
            "b": torch.tensor(rng.integers(0, 9, (K_,)))}
    back = scatter_clients(gather_clients(tree, idx), tree, idx)
    assert all(torch.equal(back[k], tree[k]) for k in tree)
    z = scatter_zeros(tree["a"][idx] + 1.0, K_, idx)
    rest = [k for k in range(K_) if k not in set(idx.tolist())]
    assert bool((z[rest] == 0.0).all())
    assert torch.equal(z[idx], tree["a"][idx] + 1.0)


def test_active_indices_matches_reference_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @st.composite
    def masks(draw):
        bits = draw(st.lists(st.booleans(), min_size=1, max_size=16))
        budget = draw(st.integers(max(1, sum(bits)), len(bits)))
        return np.array(bits, np.float32), budget

    @given(masks())
    @settings(deadline=None, max_examples=40)
    def check(mb):
        mask, budget = mb
        np.testing.assert_array_equal(
            active_indices(torch.tensor(mask), budget).numpy(),
            np.asarray(j_active_indices(jnp.asarray(mask), budget)))

    check()


@pytest.mark.parametrize("mask,what", [
    ([[1, 0, 1, 0], [0, 0, 0, 0]], r"\[0, 2\]"),
    ([[1, 1, 1, 0], [0, 1, 0, 0]], r"\[1, 3\]")])
def test_plan_check_raises(task, mask, what):
    algo = DSFLAlgorithm(apply_tiny_mlp, DSFLConfig(**HP), device="cpu")
    with pytest.raises(ValueError, match=what):
        FedEngine(algo).run(None, task[1], ctx_plan={
            "mask": torch.tensor(mask, dtype=torch.float32)}, active_budget=2)


def test_host_hooks(task, draws):
    """``on_ctx`` supplying the mask gives the ``ctx_plan`` run bitwise;
    ``on_round`` and ``on_chunk`` see every round in order."""
    _, want, _ = _port_run(task, "mlp", "era", 2, draws=draws)
    (_, port_task), (port, _) = task, numpy_models(INITS["mlp"], K, 1)
    seen = []
    algo = DSFLAlgorithm(apply_tiny_mlp, DSFLConfig(**HP, aggregation="era"),
                         use_kernel=True, device="cpu")

    def on_ctx(r, ctx):
        seen.append(("ctx", r))
        return dataclasses.replace(ctx, mask=torch.tensor(MASK[r]))

    def on_round(r, state):
        seen.append(("round", r))
        return state

    eng = FedEngine(algo, on_ctx=on_ctx, on_round=on_round,
                    on_chunk=lambda n, s: seen.append(("chunk", n)))
    got = eng.run(algo.init_from(*port), port_task, draws=draws,
                  active_budget=2)
    assert seen == [("ctx", 0), ("round", 0), ("chunk", 1),
                    ("ctx", 1), ("round", 1), ("chunk", 2)]
    a, b = _leaves(got), _leaves(want)
    for name in b:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
