"""LLM-scale DS-FL and FedAvg training of the dense family in the port
(`repro_torch.core.llm_dsfl` on `repro_torch.models.transformer`'s attention
and MLP blocks) against the reference's `repro.core.llm_dsfl`, on
``qwen1.5-4b``'s smoke config (2 layers, d 128, 4 heads of 32, vocab 512,
float32; the config the reference's own LLM tests run), K = 2, batch 2,
seq 32, from the reference's client-stacked init carried across by
``convert`` and tokens drawn with numpy: the open-batch prediction, the
ERA and SA teachers, one and two DS-FL rounds with the kernel route
(``use_kernel=True``: the kernels' plain versions on the CPU) and without,
a top-k 8 round, a participation-sparse round (bitwise the dense weighted
round), a FedAvg round and the plain SGD step.  Then one DS-FL round of
``phi3-medium-14b``'s smoke config with grouped-query heads (4 over 2) and
a 16-token sliding window, which holds the attention backward under both;
and ``launch.train``'s main on the dense archs in every mode.

Tolerances as in tests/test_torch_llm_dsfl.py: the f32 probabilities and
teacher at atol 1e-6; bf16 uploads and teacher within one bf16 step of the
value; leaves and loss after one round at atol 1e-5, after two at 1e-4
(loss values are about 90, so the loss takes rtol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import aggregation as jagg
from repro.core import llm_dsfl as J
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.core import llm_dsfl as T
from repro_torch.launch import train

from test_torch_convert import flat_ref, to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

ARCH = "qwen1.5-4b"
K, B, S = 2, 2, 32
BF16_STEP = 2.0 ** -8
ROUND_TOL = {1: 1e-5, 2: 1e-4}
MASK = np.array([1.0, 0.0], np.float32)
WEIGHTS = MASK * 0.7
# phi3-medium-14b cut to grouped-query heads and a window shorter than S
PHI3 = dict(n_heads=4, n_kv_heads=2, sliding_window=16)


def _configs(arch, **kw):
    return (jget_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


def _setup(arch, seed=0, **kw):
    jcfg, cfg = _configs(arch, **kw)
    jst = jax.jit(jax.vmap(lambda k: japi.model_init(jcfg, k)))(
        jax.random.split(jax.random.PRNGKey(seed), K))
    rng = np.random.default_rng(seed)
    pt = rng.integers(0, cfg.vocab, (K, B, S))
    ot = rng.integers(0, cfg.vocab, (B, S))
    return dict(
        jcfg=jcfg, cfg=cfg, jst=jst, tst=to_port(jst),
        jpb={"tokens": jnp.asarray(pt, jnp.int32)},
        job={"tokens": jnp.asarray(ot, jnp.int32)},
        tpb={"tokens": torch.as_tensor(pt)},
        tob={"tokens": torch.as_tensor(ot)})


@pytest.fixture(scope="module")
def setup():
    return _setup(ARCH)


def assert_leaves_close(port: dict, ref_tree, atol):
    ref = flat_ref(ref_tree)
    assert set(port) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(port[k].float().numpy(), v, atol=atol,
                                   rtol=0, err_msg=k)


def assert_loss_close(port, ref, atol):
    np.testing.assert_allclose(float(port), float(ref), atol=atol, rtol=1e-6)


def assert_bf16_close(port: torch.Tensor, ref):
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(), np.asarray(ref, np.float32),
                               atol=1e-6, rtol=BF16_STEP)


# ------------------------------------------------------------ prediction ----
@pytest.mark.parametrize("use_kernel", [False, True])
def test_predict_open_probs_matches_reference(setup, use_kernel):
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    jp1 = jax.tree.map(lambda a: a[1], setup["jst"])
    ref, jl = jax.jit(lambda p, b: (J.predict_open_probs(jcfg, p, b),
                                    japi.model_logits(jcfg, p, b)[0]))(
        jp1, setup["job"])
    out = T.predict_open_probs(cfg, T.client(setup["tst"], 1), setup["tob"],
                               use_kernel)
    assert tuple(out.shape) == (B, S, cfg.vocab)
    assert_bf16_close(out, ref)
    with torch.no_grad():
        tl, _ = T.model_logits(cfg, T.client(setup["tst"], 1), setup["tob"])
    np.testing.assert_allclose(torch.softmax(tl, -1).numpy(),
                               np.asarray(jax.nn.softmax(jl, -1)), atol=1e-6)


# --------------------------------------------------------------- teacher ----
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("aggregation", ["era", "sa"])
def test_teacher_matches_reference(setup, aggregation, use_kernel):
    """The uploads of both clients, then the teacher on them: the bf16
    teacher the clients distill on, and its f32 value before the cast."""
    cfg = setup["cfg"]
    hp = T.LLMDsflHP(aggregation=aggregation, use_kernel=use_kernel)
    (tp,) = T.dsfl_exchange(cfg, setup["tst"], setup["tob"], hp)
    jp = jnp.asarray(tp.float().numpy()).astype(jnp.bfloat16)
    jhp = J.LLMDsflHP(aggregation=aggregation)
    assert_bf16_close(T._aggregate_teacher(tp, hp, None),
                      J._aggregate_teacher(jp, jhp, None))
    jf32 = jagg.era(jp, 0.1) if aggregation == "era" else jagg.sa(jp)
    np.testing.assert_allclose(T._aggregate(tp, hp, None).numpy(),
                               np.asarray(jf32), atol=1e-6)


# ----------------------------------------------------------------- rounds ----
@pytest.fixture(scope="module")
def ref_rounds(setup):
    """The reference's first two ERA rounds and one weighted ERA round
    (client 1 absent)."""
    jcfg, hp = setup["jcfg"], J.LLMDsflHP(lr=5e-3)
    f = jax.jit(lambda p, a, b: J.dsfl_round_step(jcfg, p, a, b, hp))
    r1 = f(setup["jst"], setup["jpb"], setup["job"])
    r2 = f(r1[0], setup["jpb"], setup["job"])
    weighted = jax.jit(lambda p, a, b: J.dsfl_round_step(
        jcfg, p, a, b, hp, weights=jnp.asarray(WEIGHTS),
        mask=jnp.asarray(MASK)))(setup["jst"], setup["jpb"], setup["job"])
    return dict(era=(r1, r2), weighted=weighted)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_rounds_match_reference(setup, ref_rounds, use_kernel):
    hp = T.LLMDsflHP(lr=5e-3, use_kernel=use_kernel)
    st = setup["tst"]
    for n, ref in enumerate(ref_rounds["era"], start=1):
        st, loss = T.dsfl_round_step(setup["cfg"], st, setup["tpb"],
                                     setup["tob"], hp)
        assert_leaves_close(st, ref[0], ROUND_TOL[n])
        assert_loss_close(loss, ref[1], ROUND_TOL[n])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sparse_round_equals_dense_weighted_bitwise_and_reference(
        setup, ref_rounds, use_kernel):
    """``active_budget=1`` computes the one participant of two clients: the
    same bits as the dense weighted round, which is the reference's."""
    hp = T.LLMDsflHP(lr=5e-3, use_kernel=use_kernel)
    w, m = torch.as_tensor(WEIGHTS), torch.as_tensor(MASK)
    run = lambda budget: T.dsfl_round_step(
        setup["cfg"], setup["tst"], setup["tpb"], setup["tob"], hp,
        weights=w, mask=m, active_budget=budget)
    dense, sparse = run(None), run(1)
    for k in dense[0]:
        assert torch.equal(dense[0][k], sparse[0][k]), k
        assert torch.equal(sparse[0][k][1], setup["tst"][k][1]), k
    assert torch.equal(dense[1], sparse[1])
    assert_leaves_close(sparse[0], ref_rounds["weighted"][0], ROUND_TOL[1])
    assert_loss_close(sparse[1], ref_rounds["weighted"][1], ROUND_TOL[1])


def test_topk_round_matches_reference(setup):
    """A top-k 8 round: the exchange keeps each token's 8 largest values,
    the teacher is the ERA of the densified uploads (K1 on the CPU's plain
    version)."""
    jcfg = setup["jcfg"]
    ref = jax.jit(lambda p, a, b: J.dsfl_round_step(
        jcfg, p, a, b, J.LLMDsflHP(lr=5e-3, topk=8)))(
        setup["jst"], setup["jpb"], setup["job"])
    out = T.dsfl_round_step(setup["cfg"], setup["tst"], setup["tpb"],
                            setup["tob"],
                            T.LLMDsflHP(lr=5e-3, topk=8, use_kernel=True))
    assert_leaves_close(out[0], ref[0], ROUND_TOL[1])
    assert_loss_close(out[1], ref[1], ROUND_TOL[1])


def test_fedavg_round_matches_reference(setup):
    ref = jax.jit(lambda p, a: J.fedavg_round_step(setup["jcfg"], p, a, 1e-2))(
        setup["jst"], setup["jpb"])
    new, loss = T.fedavg_round_step(setup["cfg"], setup["tst"], setup["tpb"],
                                    1e-2)
    assert_leaves_close(new, ref[0], ROUND_TOL[1])
    assert_loss_close(loss, ref[1], ROUND_TOL[1])
    for k, v in new.items():                   # every client the mean
        assert torch.equal(v[0], v[1]), k


def test_sgd_train_step_matches_reference(setup):
    jp = jax.tree.map(lambda a: a[0], setup["jst"])
    jb = jax.tree.map(lambda a: a[0], setup["jpb"])
    rp, rl = jax.jit(lambda p, b: J.sgd_train_step(setup["jcfg"], p, b,
                                                   1e-2))(jp, jb)
    new, loss = T.sgd_train_step(setup["cfg"], T.client(setup["tst"], 0),
                                 T.client(setup["tpb"], 0), 1e-2)
    assert_leaves_close(new, rp, ROUND_TOL[1])
    assert_loss_close(loss, rl, ROUND_TOL[1])


def test_gqa_sliding_window_round_matches_reference():
    """phi3-medium-14b's smoke config with 4 query heads over 2 KV heads
    and a 16-token window over 32 tokens: one DS-FL round through the
    kernel route, so the attention backward runs under grouped heads and
    the window's mask."""
    s = _setup("phi3-medium-14b", seed=3, **PHI3)
    assert (s["cfg"].n_heads, s["cfg"].n_kv_heads) == (4, 2)
    ref = jax.jit(lambda p, a, b: J.dsfl_round_step(
        s["jcfg"], p, a, b, J.LLMDsflHP(lr=5e-3)))(s["jst"], s["jpb"],
                                                  s["job"])
    out = T.dsfl_round_step(s["cfg"], s["tst"], s["tpb"], s["tob"],
                            T.LLMDsflHP(lr=5e-3, use_kernel=True))
    assert_leaves_close(out[0], ref[0], ROUND_TOL[1])
    assert_loss_close(out[1], ref[1], ROUND_TOL[1])


# ------------------------------------------------------------ the launcher ---
@pytest.mark.parametrize("mode", ["dsfl", "fedavg", "local"])
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "gemma-7b"])
def test_train_main_runs_the_dense_family(arch, mode, capsys):
    train.main(["--arch", arch, "--mode", mode, "--smoke", "--device", "cpu",
                "--clients", "2", "--batch", "2", "--seq", "16",
                "--steps", "2"])
    out = capsys.readouterr().out
    assert f"arch={arch} (dense) layers=2 d=128 vocab=512 device=cpu" in out
    lines = [l for l in out.splitlines()
             if l.startswith(("round", "step"))]
    assert len(lines) == 2
    assert all(np.isfinite(float(l.split("loss")[1].split()[0]))
               for l in lines)
