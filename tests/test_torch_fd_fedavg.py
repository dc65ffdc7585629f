"""The paper's baselines, FD (`repro_torch.core.fd`, `FDAlgorithm`) and
FedAvg (`repro_torch.core.fedavg`, `FedAvgAlgorithm`), against the
reference's, and their sparse rounds against their dense masked rounds.

Tolerances: FD's Eq. 4-6 functions on the same inputs, atol 1e-6 (fp32,
reassociated sums of at most 80 terms of probabilities).  One client's
Eq. 7 update, and 2 rounds through ``FedEngine.run`` (K=4; FD on
``tiny_mlp``, FedAvg on the narrow 16x16 MNIST CNN, whose BatchNorm
statistics FedAvg averages; the reference's per-client draws injected) to
tests/test_torch_round.py's atol 2e-4, rtol 1e-3, in dense, masked and
participation-sparse form.  Inside the port, sparse against dense masked on
``tiny_mlp`` is bitwise: every leaf and the loss.  The reference's
``test_fd_through_fedengine_improves`` fails under the installed jax, so FD
is held round by round, not by an accuracy claim."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import client as jclient
from repro.core import fd as jfd
from repro.core.algorithms import FDAlgorithm as JFD
from repro.core.algorithms import FDConfig as JFDConfig
from repro.core.algorithms import FedAvgAlgorithm as JFedAvg
from repro.core.algorithms import FedAvgConfig as JFedAvgConfig
from repro.core.engine import FedEngine as JEngine
from repro.models.smallnets import apply_mnist_cnn as j_apply_cnn
from repro.models.smallnets import apply_tiny_mlp as j_apply_mlp
from repro.optim.optimizers import sgd as j_sgd
from repro_torch.core import fd
from repro_torch.core.algorithms import (FDAlgorithm, FDConfig,
                                         FedAvgAlgorithm, FedAvgConfig)
from repro_torch.core.client import LocalSpec, local_update
from repro_torch.core.engine import FedEngine
from repro_torch.models.smallnets import (apply_mnist_cnn, apply_tiny_mlp,
                                          init_mnist_cnn, init_tiny_mlp)
from repro_torch.optim.optimizers import sgd

from test_torch_convert import (_perm_stack, assert_flat_close,
                                assert_state_close, numpy_models, numpy_task,
                                reference_run_draws)

from test_torch_convert import one_intra_op_thread  # noqa: F401

K, ROUNDS, N_K = 4, 2, 80
ATOL_FN = 1e-6
ATOL, RTOL = 2e-4, 1e-3
HP = dict(rounds=ROUNDS, local_epochs=1, batch_size=40)
MASK = np.array([[1, 0, 1, 1], [0, 1, 1, 0]], np.float32)
PLANS = {"dense": ({}, None), "masked": ({}, MASK),
         "sparse": ({"active_budget": 3}, MASK)}
CNN = functools.partial(init_mnist_cnn, image_hw=16, widths=(8, 16), fc=32,
                        device="cpu")
MLP = functools.partial(init_tiny_mlp, device="cpu")


@pytest.fixture(scope="module")
def task():
    return numpy_task(4, K, N_K, 40, 40)


def test_fd_functions_match_reference(task):
    ref_task, port_task = task
    (pk, _, _, _), (jk, _, _, _) = numpy_models(MLP, K, 5)
    x, y = port_task.x_clients, port_task.y_clients
    jy = ref_task.y_clients
    tk, owns = zip(*(fd.per_label_logits(apply_tiny_mlp,
                                         {k: v[i] for k, v in pk.items()},
                                         {}, x[i], y[i], 10)
                     for i in range(K)))
    tk, owns = torch.stack(tk), torch.stack(owns)
    jtk, jowns = jax.vmap(lambda w, xk, yk: jfd.per_label_logits(
        j_apply_mlp, w, {}, xk, yk, 10))(jk, ref_task.x_clients, jy)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jtk), rtol=0,
                               atol=ATOL_FN)
    np.testing.assert_array_equal(owns.numpy(), np.asarray(jowns))
    owns[1, :] = False                   # a client out of the Eq. 5 mean
    tg, n_own = fd.aggregate_fd(tk, owns)
    jtg, jn = jfd.aggregate_fd(jnp.asarray(tk.numpy()),
                               jnp.asarray(owns.numpy()))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jtg), rtol=0,
                               atol=ATOL_FN)
    np.testing.assert_array_equal(n_own.numpy(), np.asarray(jn))
    assert set(n_own.tolist()) >= {1.0, 2.0}     # sole and shared owners
    for i in range(K):
        np.testing.assert_allclose(
            fd.distill_targets(tg, tk[i], n_own, y[i]).numpy(),
            np.asarray(jfd.distill_targets(jtg, jnp.asarray(tk[i].numpy()),
                                           jn, jy[i])),
            rtol=0, atol=ATOL_FN)


def test_fd_local_update_matches_reference(task):
    """One client's Eq. 7 update (labels plus gamma times the soft-target
    term) from the reference's key, as the port's permutations."""
    ref_task, port_task = task
    (pk, _, _, _), (jk, _, _, _) = numpy_models(MLP, K, 6)
    rng = np.random.default_rng(6)
    tgt = rng.random((N_K, 10)).astype(np.float32)
    tgt /= tgt.sum(-1, keepdims=True)
    key = jax.random.PRNGKey(3)
    w0 = jax.tree.map(lambda a: a[0], jk)
    jw, _, _, jloss = jclient.local_update(
        jclient.LocalSpec(j_apply_mlp, j_sgd(0.1), 2, 40), w0, {}, (),
        ref_task.x_clients[0], ref_task.y_clients[0], key,
        distill_extra=jnp.asarray(tgt), gamma=0.7)
    perms = torch.as_tensor(np.asarray(_perm_stack(key, 2, N_K, 40),
                                       np.int64))[None]
    w, _, _, loss = local_update(
        LocalSpec(apply_tiny_mlp, sgd(0.1), 2, 40),
        {k: v[:1] for k, v in pk.items()}, {}, {}, port_task.x_clients[:1],
        port_task.y_clients[:1], perms=perms,
        distill_extra=torch.tensor(tgt)[None], gamma=0.7)
    assert_flat_close({k: v[0] for k, v in w.items()}, jw, ATOL, RTOL)
    np.testing.assert_allclose(float(loss[0]), float(jloss), atol=ATOL,
                               rtol=RTOL)


def _runs(task, kind, plan, seed):
    """The reference's and the port's run of ``kind`` under ``plan``."""
    ref_task, port_task = task
    kw, mask = PLANS[plan]
    if kind == "fd":
        port, ref = numpy_models(MLP, K, seed)
        jalgo = JFD(j_apply_mlp, JFDConfig(**HP))
        algo = FDAlgorithm(apply_tiny_mlp, FDConfig(**HP), device="cpu")
        jstate, state = jalgo.init_from(*ref[:2]), algo.init_from(*port[:2])
    else:
        port, ref = numpy_models(CNN, K, seed)
        jalgo = JFedAvg(j_apply_cnn, JFedAvgConfig(**HP))
        algo = FedAvgAlgorithm(apply_mnist_cnn, FedAvgConfig(**HP),
                               device="cpu")
        jstate, state = jalgo.init_from(*ref[2:]), algo.init_from(*port[2:])
    jeng, eng = JEngine(jalgo), FedEngine(algo)
    jstate = jeng.run(jstate, ref_task, ctx_plan=(
        None if mask is None else {"mask": jnp.asarray(mask)}), **kw)
    state = eng.run(state, port_task, ctx_plan=(
        None if mask is None else {"mask": torch.tensor(mask)}),
        draws=reference_run_draws(JFDConfig(**HP), K, N_K, None, ROUNDS,
                                  local_only=True), **kw)
    return (jeng, jstate), (eng, state)


@pytest.mark.parametrize("plan", ["dense", "masked", "sparse"])
@pytest.mark.parametrize("kind", ["fd", "fedavg"])
def test_round_matches_reference(task, kind, plan):
    (jeng, jstate), (eng, state) = _runs(task, kind, plan, 7)
    assert_state_close(state, jax.device_get(jstate), atol=ATOL, rtol=RTOL)
    assert len(eng.history) == len(jeng.history) == ROUNDS
    for a, b in zip(eng.history, jeng.history):
        assert set(a) == set(b)
        for key in b:
            np.testing.assert_allclose(a[key], b[key], atol=ATOL, rtol=RTOL,
                                       err_msg=key)
    for key, v in jeng.last_metrics.items():
        np.testing.assert_allclose(eng.last_metrics[key].numpy(),
                                   np.asarray(v), atol=ATOL, rtol=RTOL,
                                   err_msg=key)


@pytest.mark.parametrize("kind", ["fd", "fedavg"])
def test_sparse_equals_dense_masked_in_port(task, kind):
    _, port_task = task
    port, _ = numpy_models(MLP, K, 8)
    draws = reference_run_draws(JFDConfig(**HP), K, N_K, None, ROUNDS,
                                local_only=True)
    out = []
    for budget in (None, 3):
        algo = (FDAlgorithm(apply_tiny_mlp, FDConfig(**HP), device="cpu")
                if kind == "fd" else
                FedAvgAlgorithm(apply_tiny_mlp, FedAvgConfig(**HP),
                                device="cpu"))
        state = (algo.init_from(*port[:2]) if kind == "fd"
                 else algo.init_from(*port[2:]))
        eng = FedEngine(algo)
        out.append((eng.run(state, port_task, draws=draws,
                            active_budget=budget,
                            ctx_plan={"mask": torch.tensor(MASK)}), eng))
    (dense, de), (sparse, se) = out
    for part in ("clients", "server"):
        for f in ("params", "model_state", "opt_update"):
            a = getattr(getattr(dense, part), f, {})
            b = getattr(getattr(sparse, part), f, {})
            assert set(a) == set(b)
            for k in a:
                assert torch.equal(a[k], b[k]), (part, f, k)
    if kind == "fd":
        assert torch.equal(de.last_metrics["global_logit"],
                           se.last_metrics["global_logit"])
    assert [h["update_loss"] for h in de.history] == \
        [h["update_loss"] for h in se.history]


def test_fd_eval_params_are_the_mean_client(task):
    port, _ = numpy_models(CNN, K, 9)
    algo = FDAlgorithm(apply_mnist_cnn, FDConfig(**HP), device="cpu")
    w, s = algo.eval_params(algo.init_from(*port[:2]))
    for k, v in port[0].items():
        assert torch.equal(w[k], v.mean(dim=0))
    assert set(s) == set(port[1])
