"""The port's weight converters, its import purity and its device rule —
and the helpers the other ``test_torch_*`` files share: tree converters,
leaf-by-leaf comparison, and the reference's per-round draws rebuilt with
``jax.random`` so the port can be handed exactly the same randomness."""
import ast
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.client import _epoch_perm
from repro_torch import convert
from repro_torch.core.algorithms import RoundDraws

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


# ------------------------------------------------------------ shared helpers --
@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """A port test module runs torch on one intra-op thread (every
    ``test_torch_*`` file imports this): the test workers share the host's
    cores, and torch's pools of a thread per core then spin against each
    other (the quickstart twin's file took 379.6 s beside five other test
    files, 16.8 s on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_np(tree):
    """A reference pytree as numpy leaves (same structure)."""
    return jax.device_get(tree)


def to_port(tree):
    """A reference pytree of params/state as the port's flat CPU dict."""
    return convert.from_numpy_tree(to_np(tree), CPU)


def flat_ref(tree) -> dict:
    """A reference pytree as a flat ``{"a/b": ndarray}`` dict."""
    return convert.flatten_tree(to_np(tree))


def assert_flat_close(port: dict, ref_tree, atol, rtol=0.0, what=""):
    """Every leaf of the port's flat dict allclose to the reference's."""
    ref = flat_ref(ref_tree)
    assert set(port) == set(ref), (what, sorted(port), sorted(ref))
    for k, v in ref.items():
        np.testing.assert_allclose(port[k].detach().cpu().numpy(), v,
                                   atol=atol, rtol=rtol, err_msg=f"{what}{k}")


def assert_state_close(port_state, ref_state, atol, rtol=0.0):
    """Every RoundState leaf of the port allclose to the reference's."""
    for part in ("clients", "server"):
        p, r = getattr(port_state, part), getattr(ref_state, part)
        for f in p.__dataclass_fields__:
            assert_flat_close(getattr(p, f), getattr(r, f), atol, rtol,
                              what=f"{part}.{f}.")


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _perm_stack_jit(key, epochs, n, bs):
    return jax.vmap(lambda k: _epoch_perm(k, n, bs))(
        jax.random.split(key, epochs))


def _perm_stack(key, epochs, n, bs):
    """(epochs, nb, bs): the epoch permutations `local_update` /
    `local_distill` draw from one client's key."""
    return np.asarray(_perm_stack_jit(key, epochs, n, bs))


def reference_round_draws(rng, K, hp, n_k, n_open, local_only=False):
    """The randomness of one reference round, rebuilt from the engine's key
    chain: ``rng, rk, ri = split(rng, 3)``; o_r from ``ri``; the round's
    legs ``r1, r2, r3, r4 = split(rk, 4)``, each client's epoch keys
    ``split(split(r, K)[k], epochs)`` and each epoch's permutation from
    ``repro.core.client._epoch_perm``.  Returns the next chain key and the
    round's draws as a port `RoundDraws`.

    ``local_only=True`` is the FD / FedAvg form: no o_r and no four-way
    split; client k's update permutations come from ``split(rk, K)[k]``."""
    rng, rk, ri = jax.random.split(rng, 3)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int64))
    bs_u = min(hp.batch_size, n_k)
    if local_only:
        return rng, RoundDraws(update_perms=t(np.stack([
            _perm_stack(k, hp.local_epochs, n_k, bs_u)
            for k in jax.random.split(rk, K)])))
    n_r = min(hp.open_batch, n_open)
    o_idx = jax.random.choice(ri, n_open, (n_r,), replace=False)
    r1, r2, _r3, r4 = jax.random.split(rk, 4)
    bs_d = min(hp.batch_size, hp.open_batch, n_r)
    upd = np.stack([_perm_stack(k, hp.local_epochs, n_k, bs_u)
                    for k in jax.random.split(r1, K)])
    dis = np.stack([_perm_stack(k, hp.distill_epochs, n_r, bs_d)
                    for k in jax.random.split(r2, K)])
    srv = _perm_stack(r4, hp.distill_epochs, n_r, bs_d)
    return rng, RoundDraws(o_idx=t(o_idx), update_perms=t(upd),
                           distill_perms=t(dis), server_perms=t(srv))


def reference_run_draws(hp, K, n_k, n_open, rounds, local_only=False):
    """`reference_round_draws` for the first ``rounds`` rounds of a run."""
    rng = jax.random.PRNGKey(hp.seed)
    out = []
    for _ in range(rounds):
        rng, d = reference_round_draws(rng, K, hp, n_k, n_open, local_only)
        out.append(d)
    return out


def numpy_task(seed, K, n_k, n_open, n_test, hw=16, n_classes=10):
    """One federated image task drawn with numpy, as the reference's
    ``FederatedImageTask`` (jnp arrays) and the port's (CPU tensors).
    Client k holds labels k, k+1 and k+2 (mod C), so some classes have one
    owner and some several (both branches of FD's Eq. 6)."""
    from repro.data.pipeline import FederatedImageTask as JTask
    from repro_torch.data.pipeline import FederatedImageTask
    rng = np.random.default_rng(seed)
    img = lambda *lead: rng.random(lead + (hw, hw, 1), np.float32)
    yc = (np.arange(K)[:, None] + rng.integers(0, 3, (K, n_k))) % n_classes
    arrays = (img(K, n_k), yc.astype(np.int32), img(n_open), img(n_test),
              rng.integers(0, n_classes, n_test).astype(np.int32))
    return (JTask(*(jax.numpy.asarray(a) for a in arrays), n_classes),
            FederatedImageTask(*(torch.as_tensor(a).long()
                                 if a.dtype == np.int32 else
                                 torch.as_tensor(a) for a in arrays),
                               n_classes))


def numpy_models(init, K, seed):
    """A server model and K client models from the port's ``init`` on the
    CPU: the port's ``(wk, sk, wg, sg)`` flat dicts, and the same values as
    the reference's nested jnp trees."""
    gen = torch.Generator().manual_seed(seed)
    wg, sg = init(gen)
    inits = [init(gen) for _ in range(K)]
    wk, sk = ({k: torch.stack([m[i][k] for m in inits]) for k in inits[0][i]}
              for i in (0, 1))
    port = (wk, sk, wg, sg)
    ref = tuple(jax.tree.map(jax.numpy.asarray, convert.to_numpy_tree(t))
                for t in port)
    return port, ref


# --------------------------------------------------------------------- tests --
def test_tree_roundtrip_and_flat_names():
    tree = {"c1": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                   "b": np.zeros(3, np.float32)},
            "bn1": {"scale": np.ones(3, np.float32)}}
    flat = convert.from_numpy_tree(tree, CPU)
    assert sorted(flat) == ["bn1/scale", "c1/b", "c1/w"]
    assert flat["c1/w"].dtype == torch.float32
    back = convert.to_numpy_tree(flat)
    np.testing.assert_array_equal(back["c1"]["w"], tree["c1"]["w"])
    # the tensors are copies: writing one leaves the array alone
    flat["c1/w"][0, 0] = 99.0
    assert tree["c1"]["w"][0, 0] == 0.0
    # the reference's SGD state is the empty tuple
    assert convert.from_numpy_tree((), CPU) == {}


def test_bf16_leaves_cross_exactly():
    """The reference's bf16 leaves (ml_dtypes arrays in numpy) land as
    torch.bfloat16 with the same values, and come back as float32."""
    import jax.numpy as jnp
    vals = np.array([[1.0, -2.5, 3.140625], [1e-3, 65280.0, -0.0]],
                    np.float32)
    tree = to_np({"embed": {"tok": jnp.asarray(vals, jnp.bfloat16)}})
    assert tree["embed"]["tok"].dtype.name == "bfloat16"
    flat = convert.from_numpy_tree(tree, CPU)
    t = flat["embed/tok"]
    assert t.dtype == torch.bfloat16
    want = np.asarray(jnp.asarray(vals, jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(t.float().numpy(), want)
    back = convert.to_numpy_tree(flat)["embed"]["tok"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, want)


def test_round_state_roundtrip_from_reference(rng):
    from repro.core.algorithms import DSFLAlgorithm
    from repro.core.protocol import DSFLConfig
    from repro.models.smallnets import apply_tiny_mlp, init_tiny_mlp
    hp = DSFLConfig(optimizer="adam")
    algo = DSFLAlgorithm(apply_tiny_mlp, hp)
    wg, sg = init_tiny_mlp(rng)
    wk, sk = jax.vmap(init_tiny_mlp)(jax.random.split(rng, 3))
    ref = algo.init_from(wk, sk, wg, sg)
    port = convert.round_state_from_numpy(to_np(ref), CPU)
    assert_state_close(port, ref, atol=0.0)
    assert sorted(port.clients.opt_update) == sorted(
        f"{mv}/{k}" for mv in "mv" for k in port.clients.params)
    back = convert.round_state_to_numpy(port)
    np.testing.assert_array_equal(back["server"]["params"]["d1"]["w"],
                                  np.asarray(wg["d1"]["w"]))


def test_reference_round_draws_are_the_reference_engines():
    """The rebuilt o_r is the reference engine's own first draw."""
    from repro.core.protocol import DSFLConfig
    hp = DSFLConfig(local_epochs=2, distill_epochs=1, batch_size=40,
                    open_batch=80)
    _, d = reference_round_draws(jax.random.PRNGKey(0), 4, hp, 80, 160)
    _, _, ri = jax.random.split(jax.random.PRNGKey(0), 3)
    np.testing.assert_array_equal(
        d.o_idx.numpy(), np.asarray(jax.random.choice(ri, 160, (80,),
                                                      replace=False)))
    assert tuple(d.update_perms.shape) == (4, 2, 2, 40)
    assert tuple(d.distill_perms.shape) == (4, 1, 2, 40)
    assert tuple(d.server_perms.shape) == (1, 2, 40)
    for p in d.update_perms.reshape(8, 80):
        assert sorted(p.tolist()) == list(range(80))


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("where", ["package", "chip_smoke", "example"])
def test_port_imports_neither_jax_nor_the_reference(where):
    files = {"package": sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
             "chip_smoke": [ROOT / "chip_smoke.py"],
             "example": sorted((ROOT / "examples").glob("torch_*.py"))}[where]
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)


def test_cuda_request_without_card_raises(monkeypatch):
    """Entry points default to the card and raise without one; nothing
    quietly runs on the CPU."""
    from repro_torch.core.algorithms import DSFLAlgorithm
    from repro_torch.core.engine import FedEngine
    from repro_torch.core.protocol import DSFLConfig
    from repro_torch.data.pipeline import build_image_task
    from repro_torch.device import resolve_device
    from repro_torch.models.smallnets import apply_tiny_mlp, init_tiny_mlp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    from repro_torch.core.algorithms import (FDAlgorithm, FDConfig,
                                             FedAvgAlgorithm, FedAvgConfig)
    for algo, hp in ((DSFLAlgorithm, DSFLConfig()), (FDAlgorithm, FDConfig()),
                     (FedAvgAlgorithm, FedAvgConfig())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            algo(apply_tiny_mlp, hp)
    # the engine has no device of its own: it runs where its algorithm does
    assert FedEngine(DSFLAlgorithm(apply_tiny_mlp, DSFLConfig(), device=CPU)
                     ).device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_image_task(0, 2, 20, 10, 10)
    from repro_torch.data.pipeline import SyntheticProvider
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticProvider(0, 10, 2, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_tiny_mlp(torch.Generator())
    assert resolve_device(CPU).type == "cpu"


def test_unported_options_raise():
    """What is still refused: the pipelined schedule for an algorithm
    without round halves (FD, as in the reference).  Fused chunks and
    ``overlap`` are ported, and so are the paper's four models and the
    Dirichlet partition: they build where they once raised."""
    from repro_torch.core.algorithms import FDAlgorithm, FDConfig
    from repro_torch.core.engine import FedEngine
    from repro_torch.data.pipeline import build_image_task
    from repro_torch.models.smallnets import apply_tiny_mlp, make_smallnet
    eng = FedEngine(FDAlgorithm(apply_tiny_mlp, FDConfig(), device=CPU))
    with pytest.raises(ValueError, match="round_start"):
        eng.run(None, None, chunk_rounds=2, overlap=True)
    assert make_smallnet("fmnist_cnn", device=CPU).input_kind == "image"
    task = build_image_task(0, 2, 20, 10, 10, distribution="dirichlet:0.5",
                            device=CPU)
    assert task.x_clients.shape[0] == 2
