"""The paper's other three models (F-MNIST CNN, Reuters DNN, IMDb LSTM)
against the reference: forward passes, gradients, parameter counts and
names, the client loops, and one whole DS-FL round, from converted
reference parameters and with the reference's own draws injected.

Sizes are the reference's own small ones (tests/test_substrates.py): the
LSTM at vocab 100, embedding 8, hidden 8 and 12 tokens, the DNN at vocab
50 and widths (16, 8); the F-MNIST CNN runs at full width on 4 images."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad_and_value

from repro.core import client as jc
from repro.core.losses import xent_int_labels as j_xent
from repro.models import smallnets as jsn
from repro.optim import optimizers as jopt
from repro_torch.configs.paper_models import PAPER_MODELS, make_paper_model
from repro_torch.core import client as tc
from repro_torch.core.losses import xent_int_labels as t_xent
from repro_torch.models import smallnets as tsn
from repro_torch.optim import optimizers as topt

from test_torch_convert import (_perm_stack, assert_flat_close,
                                assert_state_close, flat_ref,
                                reference_round_draws, to_np, to_port)

from test_torch_convert import one_intra_op_thread  # noqa: F401

CPU = "cpu"
LSTM = dict(vocab=100, emb=8, hidden=8)
DNN = dict(vocab=50, widths=(16, 8))
ATOL = 1e-5


def _inputs(name, n, seed):
    """n inputs of ``name``'s kind, from numpy: NHWC images, (n, 12) tokens
    below vocab 100, or binary bags of 50 words."""
    r = np.random.default_rng(seed)
    if name == "fmnist_cnn":
        return r.standard_normal((n, 28, 28, 1)).astype(np.float32)
    if name == "imdb_lstm":
        return r.integers(0, LSTM["vocab"], (n, 12)).astype(np.int32)
    return (r.random((n, DNN["vocab"])) < 0.3).astype(np.float32)


def _port_x(x):
    return torch.from_numpy(x).long() if x.dtype == np.int32 else \
        torch.from_numpy(x)


MODELS = {   # name -> (reference init, reference apply, port apply, n)
    "fmnist_cnn": (jsn.init_fmnist_cnn, jsn.apply_fmnist_cnn,
                   tsn.apply_fmnist_cnn, 4),
    "reuters_dnn": (functools.partial(jsn.init_reuters_dnn, **DNN),
                    jsn.apply_reuters_dnn, tsn.apply_reuters_dnn, 6),
    "imdb_lstm": (functools.partial(jsn.init_imdb_lstm, **LSTM),
                  jsn.apply_imdb_lstm, tsn.apply_imdb_lstm, 5),
}


def _reference_model(name, rng):
    init, apply, tapply, n = MODELS[name]
    p, s = init(rng)
    # non-trivial running stats, so eval mode is not the identity BN
    s = jax.tree.map(lambda a: a + 0.1, s)
    return p, s, apply, tapply, n


# --------------------------------------------------------------------- models --
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_reference(rng, name, train):
    p, s, apply, tapply, n = _reference_model(name, rng)
    x = _inputs(name, n, 0)
    logits, ns = jax.jit(apply, static_argnums=3)(p, s, jnp.asarray(x), train)
    tlogits, tns = tapply(to_port(p), to_port(s), _port_x(x), train)
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(logits),
                               atol=ATOL)
    assert_flat_close(tns, ns, atol=ATOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_gradients_match_reference(rng, name):
    """``grad_and_value`` of the training loss (train mode, the new BN state
    as the aux output) against ``jax.value_and_grad``."""
    p, s, apply, tapply, n = _reference_model(name, rng)
    x = _inputs(name, n, 1)
    y = np.arange(n) % (10 if name == "fmnist_cnn" else 2)

    def jloss(p_):
        logits, ns = apply(p_, s, jnp.asarray(x), True)
        return j_xent(logits, jnp.asarray(y)), ns

    (loss, ns), g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(p)

    def tloss(p_):
        logits, tns = tapply(p_, to_port(s), _port_x(x), True)
        return t_xent(logits, torch.from_numpy(y)), tns

    tg, (tl, tns) = grad_and_value(tloss, has_aux=True)(to_port(p))
    assert abs(float(tl) - float(loss)) <= ATOL
    assert_flat_close(tg, g, atol=ATOL)
    assert_flat_close(tns, ns, atol=ATOL)


@pytest.mark.parametrize("name,values,trainable", [
    ("fmnist_cnn", 2_759_976, 2_759_080),
    ("reuters_dnn", 5_194_670, 5_193_390),
    ("imdb_lstm", 648_386, 648_386)])
def test_parameter_counts_and_names(rng, name, values, trainable):
    """The port's full-size init holds the reference's leaves, names and
    shapes, and the paper's counts (BatchNorm running statistics counted,
    as Keras does)."""
    p, s = tsn.make_smallnet(name, device=CPU).init(
        torch.Generator().manual_seed(0))
    assert tsn.param_count(p, s) == values
    assert tsn.param_count(p) == trainable
    jp, js = {"fmnist_cnn": jsn.init_fmnist_cnn,
              "reuters_dnn": jsn.init_reuters_dnn,
              "imdb_lstm": jsn.init_imdb_lstm}[name](rng)
    ref = {**flat_ref(jp), **{f"state/{k}": v for k, v in flat_ref(js).items()}}
    port = {**p, **{f"state/{k}": v for k, v in s.items()}}
    assert sorted(ref) == sorted(port)
    for k in ref:
        assert tuple(port[k].shape) == ref[k].shape, k
        assert port[k].dtype == torch.float32, k
    # the init's spread is the reference's (He normal; the LSTM's scales),
    # on the leaves of 1,000 draws or more
    for k in ref:
        if ref[k].size >= 1000 and ref[k].std() > 0:
            assert abs(float(port[k].std()) / float(ref[k].std()) - 1) < 0.1, k


def test_registry_and_paper_configs():
    """Every paper model resolves by name and by its paper id, with the
    reference's input kinds and class counts; an unknown name raises."""
    kinds = {"mnist_cnn": ("image", 10), "fmnist_cnn": ("image", 10),
             "imdb_lstm": ("tokens", 2), "reuters_dnn": ("bow", 46)}
    from repro.configs.paper_models import PAPER_MODELS as J_PAPER_MODELS
    assert PAPER_MODELS == J_PAPER_MODELS
    for arch_id, spec in PAPER_MODELS.items():
        net = make_paper_model(arch_id, device=CPU)
        assert net.name == spec["name"]
        assert (net.input_kind, net.n_classes) == kinds[net.name]
    net = make_paper_model("paper-reuters-dnn", n_classes=5, vocab=7,
                           widths=(3, 2), device=CPU)
    p, _ = net.init(torch.Generator().manual_seed(0))
    assert net.n_classes == 5 and tuple(p["d3/w"].shape) == (2, 5)
    with pytest.raises(ValueError):
        tsn.make_smallnet("no_such_model")


def test_same_padding_convolution(rng):
    """``conv2d(padding="SAME")`` keeps the spatial size and matches the
    reference's at a 3x3 kernel; VALID stays the default."""
    key = jax.random.PRNGKey(5)
    w = jax.random.normal(key, (3, 3, 2, 4))
    b = jax.random.normal(jax.random.fold_in(key, 1), (4,))
    x = np.random.default_rng(2).standard_normal((2, 9, 7, 2)).astype(
        np.float32)
    tp = {"c/w": torch.tensor(np.asarray(w)),
          "c/b": torch.tensor(np.asarray(b))}
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    for padding, hw in (("SAME", (9, 7)), ("VALID", (7, 5))):
        ref = jsn.conv2d({"w": w, "b": b}, jnp.asarray(x), padding=padding)
        out = tsn.conv2d(tp, "c", tx, padding).permute(0, 2, 3, 1)
        assert tuple(out.shape[1:3]) == hw
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    assert tsn.conv2d(tp, "c", tx).shape[2:] == (7, 5)


# --------------------------------------------------------------- client loops --
K = 3


def _stack(name, seed):
    """K reference models of ``name`` (the small sizes), private data of 20
    items a client and an open set of 16 with a soft teacher."""
    init = MODELS[name][0]
    wk, sk = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(seed), K))
    n_cls = 2 if name == "imdb_lstm" else 46
    r = np.random.default_rng(seed)
    x = _inputs(name, K * 20, seed).reshape((K, 20) + _inputs(name, 1, 0)
                                            .shape[1:])
    y = r.integers(0, n_cls, (K, 20)).astype(np.int32)
    xo = _inputs(name, 16, seed + 1)
    e = np.exp(r.standard_normal((16, n_cls)) * 2)
    teacher = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    return wk, sk, x, y, xo, teacher


def _perms(key, epochs, n, bs):
    return torch.as_tensor(np.stack(
        [_perm_stack(k, epochs, n, bs) for k in jax.random.split(key, K)]
    ).astype(np.int64))


@pytest.mark.parametrize("name", ["imdb_lstm", "reuters_dnn"])
def test_local_update_matches_reference(name):
    """2 epochs of batch 8 over 20 items (2 batches, tail dropped), SGD."""
    wk, sk, x, y, _, _ = _stack(name, 3)
    apply, tapply = MODELS[name][1], MODELS[name][2]
    jspec = jc.LocalSpec(apply, jopt.sgd(0.1), 2, 8)
    tspec = tc.LocalSpec(tapply, topt.sgd(0.1), 2, 8)
    key = jax.random.PRNGKey(9)
    jout = jax.vmap(lambda w, s, xk, yk, rk: jc.local_update(
        jspec, w, s, (), xk, yk, rk))(wk, sk, jnp.asarray(x), jnp.asarray(y),
                                      jax.random.split(key, K))
    tout = tc.local_update(tspec, to_port(wk), to_port(sk), {}, _port_x(x),
                           torch.from_numpy(y).long(),
                           perms=_perms(key, 2, 20, 8))
    for t_tree, j_tree in zip(tout[:2], jout[:2]):
        assert_flat_close(t_tree, j_tree, atol=ATOL)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               atol=ATOL)


@pytest.mark.parametrize("name", ["imdb_lstm", "reuters_dnn"])
def test_local_distill_matches_reference(name):
    """2 epochs of batch 8 over the 16 open items against the teacher."""
    wk, sk, _, _, xo, teacher = _stack(name, 4)
    apply, tapply = MODELS[name][1], MODELS[name][2]
    jspec = jc.LocalSpec(apply, jopt.sgd(0.1), 2, 8)
    tspec = tc.LocalSpec(tapply, topt.sgd(0.1), 2, 8)
    key = jax.random.PRNGKey(11)
    jout = jax.vmap(lambda w, s, rk: jc.local_distill(
        jspec, w, s, (), jnp.asarray(xo), jnp.asarray(teacher), rk))(
        wk, sk, jax.random.split(key, K))
    tout = tc.local_distill(tspec, to_port(wk), to_port(sk), {},
                            _port_x(xo), torch.from_numpy(teacher),
                            perms=_perms(key, 2, 16, 8))
    for t_tree, j_tree in zip(tout[:2], jout[:2]):
        assert_flat_close(t_tree, j_tree, atol=ATOL)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               atol=ATOL)


# ------------------------------------------------------------ one whole round --
def test_reuters_dsfl_round_matches_reference():
    """One DS-FL ERA round of the Reuters DNN at K=3 (K1's plain version on
    the port's side, the Pallas kernel in interpret mode on the
    reference's) from the reference's init and draws: every RoundState leaf
    within 2e-4 + 1e-3 |x| (the round test's tolerance,
    tests/test_torch_round.py) and the history's floats too."""
    from repro.core.algorithms import DSFLAlgorithm as JAlgo
    from repro.core.engine import FedEngine as JEngine
    from repro.core.engine import make_eval_fn as j_eval
    from repro.core.protocol import DSFLConfig as JConfig
    from repro.data.pipeline import FederatedImageTask as JTask
    from repro_torch import convert
    from repro_torch.core.algorithms import DSFLAlgorithm
    from repro_torch.core.engine import FedEngine, make_eval_fn
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.data.pipeline import FederatedImageTask
    hp = dict(rounds=1, local_epochs=1, distill_epochs=1, batch_size=10,
              open_batch=30)
    r = np.random.default_rng(0)
    arrays = [(r.random(shape) < 0.3).astype(np.float32)
              for shape in ((K, 40, 50), (60, 50), (40, 50))]
    yc = ((np.arange(K)[:, None] * 15 + r.integers(0, 15, (K, 40))) % 46
          ).astype(np.int32)
    y_test = r.integers(0, 46, 40).astype(np.int32)
    jtask = JTask(jnp.asarray(arrays[0]), jnp.asarray(yc),
                  jnp.asarray(arrays[1]), jnp.asarray(arrays[2]),
                  jnp.asarray(y_test), 46)
    task = FederatedImageTask(torch.from_numpy(arrays[0]),
                              torch.from_numpy(yc).long(),
                              torch.from_numpy(arrays[1]),
                              torch.from_numpy(arrays[2]),
                              torch.from_numpy(y_test).long(), 46)
    init = MODELS["reuters_dnn"][0]
    key = jax.random.PRNGKey(1)
    wg, sg = init(key)
    wk, sk = jax.vmap(init)(jax.random.split(key, K))
    jalgo = JAlgo(jsn.apply_reuters_dnn, JConfig(**hp), use_kernel=True)
    jeng = JEngine(jalgo, j_eval(jsn.apply_reuters_dnn, jtask.x_test,
                                 jtask.y_test))
    start = jalgo.init_from(wk, sk, wg, sg)
    jstate = jeng.run(start, jtask)
    _, draws = reference_round_draws(jax.random.PRNGKey(0), K, JConfig(**hp),
                                     40, 60)
    algo = DSFLAlgorithm(tsn.apply_reuters_dnn, DSFLConfig(**hp),
                         use_kernel=True, device=CPU)
    eng = FedEngine(algo, make_eval_fn(tsn.apply_reuters_dnn, task.x_test,
                                       task.y_test))
    state = eng.run(convert.round_state_from_numpy(to_np(start), CPU), task,
                    draws=[draws])
    assert_state_close(state, jax.device_get(jstate), atol=2e-4, rtol=1e-3)
    (a,), (b,) = eng.history, jeng.history
    assert set(a) == set(b)
    for k in b:
        tol = 1.0 / 40 + 1e-6 if k == "test_acc" else 2e-4 + 1e-3 * abs(b[k])
        assert abs(a[k] - b[k]) <= tol, (k, a[k], b[k])
