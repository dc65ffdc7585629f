"""The slice as a whole: the port's `FedEngine.run` against the
reference's, 2 rounds of DS-FL with K=4 clients on the narrow MNIST CNN,
from converted reference weights and data and with the reference's own
draws injected (o_r and every epoch permutation).

Tolerance: every RoundState leaf and every history float agrees to
atol=2e-4, rtol=1e-3 after two rounds.  The two packages sum in different
orders, so they part in the last bits after the first local step, and
every SGD step carries that forward.  For ERA, weighted ERA and the masked
round the largest leaf difference is about 1.5e-6 after round 2.  The
``sa`` run drifts further, to 5.8e-5 on one dense weight: its unsharpened
teacher gives the distillation steps larger, less peaked gradients, and
an activation sitting at a ReLU's kink can take the other side.  The
bound keeps a factor of three over that; test_acc agrees to within one
test sample (1/n_test)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core.algorithms import DSFLAlgorithm as JAlgo
from repro.core.engine import FedEngine as JEngine
from repro.core.engine import make_eval_fn as j_eval
from repro.core.protocol import DSFLConfig as JConfig
from repro.data.pipeline import build_image_task as j_task
from repro.models.smallnets import apply_mnist_cnn as j_apply
from repro.models.smallnets import init_mnist_cnn as j_init
from repro_torch import convert
from repro_torch.core.algorithms import DSFLAlgorithm
from repro_torch.core.engine import FedEngine, make_eval_fn
from repro_torch.core.protocol import DSFLConfig
from repro_torch.data.pipeline import FederatedImageTask
from repro_torch.models.smallnets import apply_mnist_cnn

from test_torch_convert import (assert_state_close, reference_run_draws,
                                to_np)

from test_torch_convert import one_intra_op_thread  # noqa: F401

K, ROUNDS, N_TEST = 4, 2, 160
ATOL, RTOL = 2e-4, 1e-3
HP = dict(rounds=ROUNDS, local_epochs=1, distill_epochs=1, batch_size=40,
          open_batch=80)


def make_setup():
    """Reference data and init (converted for the port) and its draws."""
    task = j_task(seed=0, K=K, n_private=320, n_open=160, n_test=N_TEST,
                  distribution="non_iid")
    key = jax.random.PRNGKey(0)
    init = functools.partial(j_init, image_hw=16, widths=(8, 16), fc=32)
    wg, sg = init(key)
    wk, sk = jax.vmap(init)(jax.random.split(key, K))
    t = lambda a: torch.tensor(np.asarray(a))
    port_task = FederatedImageTask(t(task.x_clients), t(task.y_clients),
                                   t(task.open_x), t(task.x_test),
                                   t(task.y_test), task.n_classes)
    draws = reference_run_draws(JConfig(**HP), K, task.x_clients.shape[1],
                                task.open_x.shape[0], ROUNDS)
    return task, port_task, (wk, sk, wg, sg), draws


@pytest.fixture(scope="module")
def setup():
    return make_setup()


def _run_both(setup, aggregation, use_kernel, ctx_plan=None):
    task, port_task, (wk, sk, wg, sg), draws = setup
    jalgo = JAlgo(j_apply, JConfig(**HP, aggregation=aggregation),
                  use_kernel=use_kernel)
    jeng = JEngine(jalgo, j_eval(j_apply, task.x_test, task.y_test))
    jstate = jeng.run(jalgo.init_from(wk, sk, wg, sg), task,
                      ctx_plan=(None if ctx_plan is None else
                                {k: jax.numpy.asarray(v)
                                 for k, v in ctx_plan.items()}))
    algo = DSFLAlgorithm(apply_mnist_cnn,
                         DSFLConfig(**HP, aggregation=aggregation),
                         use_kernel=use_kernel, device="cpu")
    eng = FedEngine(algo, make_eval_fn(apply_mnist_cnn, port_task.x_test,
                                       port_task.y_test))
    state = eng.run(convert.round_state_from_numpy(
        to_np(jalgo.init_from(wk, sk, wg, sg)), "cpu"), port_task,
        draws=draws, ctx_plan=(None if ctx_plan is None else
                               {k: torch.tensor(v)
                                for k, v in ctx_plan.items()}))
    return (jeng, jstate), (eng, state)


def _assert_same_run(ref, port):
    (jeng, jstate), (eng, state) = ref, port
    assert_state_close(state, jax.device_get(jstate), atol=ATOL, rtol=RTOL)
    assert len(eng.history) == len(jeng.history) == ROUNDS
    for a, b in zip(eng.history, jeng.history):
        assert set(a) == set(b)
        for key in b:
            tol = 1.0 / N_TEST + 1e-6 if key == "test_acc" else None
            if tol is None:
                np.testing.assert_allclose(a[key], b[key], atol=ATOL,
                                           rtol=RTOL, err_msg=key)
            else:
                assert abs(a[key] - b[key]) <= tol, (key, a[key], b[key])
    for key, v in jeng.last_metrics.items():
        np.testing.assert_allclose(eng.last_metrics[key].numpy(),
                                   np.asarray(v), atol=ATOL, rtol=RTOL,
                                   err_msg=key)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("aggregation", ["sa", "era", "weighted_era"])
def test_fedengine_matches_reference(setup, aggregation, use_kernel):
    _assert_same_run(*_run_both(setup, aggregation, use_kernel))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("aggregation", ["sa", "era", "weighted_era"])
def test_masked_round_matches_reference(setup, aggregation, use_kernel):
    """Client 1 sits out both rounds: it keeps its state and its
    aggregation weight is exactly 0.0 in both packages.  ``sa`` takes K2's
    weighted mean (``sharpen=False``) on the kernel route; ``weighted_era``
    re-estimates the reliabilities over the masked stack."""
    mask = np.tile(np.array([1, 0, 1, 1], np.float32), (ROUNDS, 1))
    ref, port = _run_both(setup, aggregation, use_kernel,
                          ctx_plan={"mask": mask})
    _assert_same_run(ref, port)
    eng, state = port
    assert float(eng.last_metrics["agg_weights"][1]) == 0.0
    assert float(ref[0].last_metrics["agg_weights"][1]) == 0.0
    wk0 = setup[2][0]
    np.testing.assert_array_equal(state.clients.params["c1/w"][1].numpy(),
                                  np.asarray(wk0["c1"]["w"][1]))
