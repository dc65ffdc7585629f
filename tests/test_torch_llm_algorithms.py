"""The port's LLM algorithms on `FedEngine` (`repro_torch.core.
llm_algorithms`) against the reference's, on ``mamba2-2.7b``'s smoke config
and the reference's own LM task and client-stacked init (``convert``
carries both across): two engine rounds of DS-FL with the reference's open
batches injected, FedAvg dense and weighted, the plain SGD step, and the
port reading the reference's checkpoint.  Then the port's own invariants:
the engine round equals the round step, chunked equals the loop and the
pipelined schedule, a resumed run equals the whole one, FedAvg syncs its
clients, sparse rounds equal dense weighted ones through the engine and the
simulator, and measured FP16, top-k and FedAvg bytes equal ``CommModel``.

Tolerances as in tests/test_torch_llm_dsfl.py: leaves and loss after one
round at atol 1e-5, after two at 1e-4; the port's invariants bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import llm_dsfl as J
from repro.core.engine import FedEngine as JEngine
from repro.core.llm_algorithms import LLMDSFLAlgorithm as JDSFL
from repro.data.pipeline import build_lm_task as jbuild_lm_task
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.core import llm_dsfl as T
from repro_torch.core import wire
from repro_torch.core.algorithms import RoundDraws
from repro_torch.core.comm import CommModel
from repro_torch.core.engine import FedEngine, open_batch
from repro_torch.core.llm_algorithms import (LLMDSFLAlgorithm,
                                             LLMFedAvgAlgorithm, LLMFedAvgHP)
from repro_torch.data.pipeline import FederatedLMTask
from repro_torch.sim import ClientPopulation, SimRunner, SyncScheduler

from test_torch_convert import flat_ref, to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

JCFG = jget_config("mamba2-2.7b").smoke()
CFG = get_config("mamba2-2.7b").smoke()
K, B, S = 2, 2, 32
CPU = "cpu"


@pytest.fixture(scope="module")
def ref():
    """The reference's task and client-stacked init."""
    task = jbuild_lm_task(seed=0, K=K, batch=B, seq=S, vocab=JCFG.vocab)
    stacked = jax.jit(jax.vmap(lambda k: japi.model_init(JCFG, k)))(
        jax.random.split(jax.random.PRNGKey(0), K))
    return task, stacked


@pytest.fixture(scope="module")
def port(ref):
    """The same task and init in the port (CPU tensors)."""
    jtask, jst = ref
    t = lambda d: {k: torch.as_tensor(np.array(v)).long()
                   for k, v in d.items()}
    return FederatedLMTask(t(jtask.x_clients), t(jtask.open_x)), to_port(jst)


def _leaves_close(port_params: dict, ref_params, atol):
    r = flat_ref(ref_params)
    assert set(port_params) == set(r)
    for k, v in r.items():
        np.testing.assert_allclose(port_params[k].float().numpy(), v,
                                   atol=atol, err_msg=k)


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _dsfl(use_kernel=False, **kw):
    hp = T.LLMDsflHP(lr=5e-3, rounds=2, seed=0, open_batch=B,
                     use_kernel=use_kernel, **kw)
    return LLMDSFLAlgorithm(CFG, hp, device=CPU)


def _ref_open_batches(hp, task, rounds):
    """The reference engine's o_r of each round from its key chain
    (``rng, rk, ri = split(rng, 3)``, o_r from ``ri``)."""
    rng = jax.random.PRNGKey(hp.seed)
    n_open = jax.tree.leaves(task.open_x)[0].shape[0]
    out = []
    for _ in range(rounds):
        rng, _, ri = jax.random.split(rng, 3)
        o = jax.random.choice(ri, n_open, (min(hp.open_batch, n_open),),
                              replace=False)
        out.append(RoundDraws(o_idx=torch.as_tensor(np.array(o)).long()))
    return out


@pytest.fixture(scope="module")
def ref_dsfl_run(ref, tmp_path_factory):
    """Two rounds of the reference's engine, and its checkpoint."""
    jtask, jst = ref
    hp = J.LLMDsflHP(lr=5e-3, rounds=2, seed=0, open_batch=B)
    algo = JDSFL(JCFG, hp)
    eng = JEngine(algo)
    out = eng.run(algo.init_from(jst), jtask, rounds=2)
    path = str(tmp_path_factory.mktemp("ref") / "llm.msgpack")
    eng.save_state(path, out)
    return out, eng.history, path


# ------------------------------------------------------------- reference ----
@pytest.mark.parametrize("use_kernel", [False, True])
def test_engine_rounds_match_reference_engine(ref, port, ref_dsfl_run,
                                              use_kernel):
    task, st = port
    jout, jhist, _ = ref_dsfl_run
    algo = _dsfl(use_kernel)
    eng = FedEngine(algo)
    out = eng.run(algo.init_from(st), task, rounds=2,
                  draws=_ref_open_batches(algo.hp, ref[0], 2))
    _leaves_close(out.clients.params, jout.clients.params, 1e-4)
    assert [h["round"] for h in eng.history] == [1, 2]
    np.testing.assert_allclose([h["loss"] for h in eng.history],
                               [h["loss"] for h in jhist], rtol=1e-6,
                               atol=1e-4)


def test_port_reads_the_reference_checkpoint(port, ref_dsfl_run):
    task, st = port
    jout, jhist, path = ref_dsfl_run
    eng = FedEngine(_dsfl())
    state = eng.load_state(path, eng.algo.init_from(st))
    assert eng.rounds_done == 2 and eng.history == jhist
    r = flat_ref(jout.clients.params)
    for k, v in state.clients.params.items():
        np.testing.assert_array_equal(v.numpy(), r[k], err_msg=k)


@pytest.fixture(scope="module")
def ref_fedavg(ref):
    """One reference FedAvg round, dense and weighted (client 1 absent)."""
    jtask, jst = ref
    w = jnp.asarray([0.6, 0.0])
    f = jax.jit(lambda p, pb, w: J.fedavg_round_step(JCFG, p, pb, 1e-3,
                                                     weights=w))
    dense = jax.jit(lambda p, pb: J.fedavg_round_step(JCFG, p, pb, 1e-3))(
        jst, jtask.x_clients)
    return dense, f(jst, jtask.x_clients, w)


def test_fedavg_engine_matches_reference_and_syncs(port, ref_fedavg):
    task, st = port
    algo = LLMFedAvgAlgorithm(CFG, LLMFedAvgHP(lr=1e-3, rounds=1),
                              device=CPU)
    eng = FedEngine(algo)
    out = eng.run(algo.init_from(st), task, rounds=1)
    _leaves_close(out.clients.params, ref_fedavg[0][0], 1e-5)
    np.testing.assert_allclose(eng.history[0]["loss"],
                               float(ref_fedavg[0][1]), rtol=1e-6)
    for k, v in out.clients.params.items():
        assert torch.equal(v[0], v[1]), k          # the broadcast synced them


def test_fedavg_sparse_equals_weighted_and_reference(port, ref_fedavg):
    task, st = port
    w = torch.tensor([0.6, 0.0])
    dense = T.fedavg_round_step(CFG, st, task.x_clients, 1e-3, weights=w)
    sparse = T.fedavg_round_step(CFG, st, task.x_clients, 1e-3, weights=w,
                                 active_budget=1)
    _equal(dense[0], sparse[0])
    assert torch.equal(dense[1], sparse[1])
    _leaves_close(sparse[0], ref_fedavg[1][0], 1e-5)
    np.testing.assert_allclose(float(sparse[1]), float(ref_fedavg[1][1]),
                               rtol=1e-6)


def test_sgd_train_step_matches_reference(ref, port):
    jtask, jst = ref
    task, st = port
    jp = jax.tree.map(lambda a: a[1], jst)
    jb = jax.tree.map(lambda a: a[1], jtask.x_clients)
    rp, rl = jax.jit(lambda p, b: J.sgd_train_step(JCFG, p, b, 1e-2))(jp, jb)
    new, loss = T.sgd_train_step(CFG, T.client(st, 1),
                                 T.client(task.x_clients, 1), 1e-2)
    _leaves_close(new, rp, 1e-5)
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-6)


def test_client_stacked_state_crosses_both_ways(ref):
    """``convert`` carries the reference's LLM RoundState (client-stacked
    nested params, leaves (K, ...); every other slot empty) into the
    port's flat names and back, exactly."""
    from repro_torch import convert
    _, jst = ref
    state = convert.round_state_from_numpy(
        jax.device_get(JDSFL(JCFG, J.LLMDsflHP()).init_from(jst)), CPU)
    assert set(state.clients.params) == set(flat_ref(jst))
    assert not (state.clients.model_state or state.clients.opt_update
                or state.server.params)
    back = convert.round_state_to_numpy(state)["clients"]["params"]
    for k, v in flat_ref(jst).items():
        assert state.clients.params[k].shape[0] == K
        np.testing.assert_array_equal(convert.flatten_tree(back)[k], v)


# ------------------------------------------------------ port invariants -----
def test_engine_round_equals_round_step_bitwise(port):
    task, st = port
    algo = _dsfl()
    eng = FedEngine(algo)
    out = eng.run(algo.init_from(st), task, rounds=1)
    o_idx = open_batch(0, 0, B, B, CPU)
    ref_p, ref_l = T.dsfl_round_step(
        CFG, st, task.x_clients,
        {k: v[o_idx] for k, v in task.open_x.items()}, algo.hp)
    _equal(out.clients.params, ref_p)
    assert eng.history[0]["loss"] == float(ref_l)


def test_chunked_overlap_and_resumed_runs_equal_the_loop(port, tmp_path):
    task, st = port
    algo = _dsfl(use_kernel=True)
    runs = {}
    for name, kw in (("loop", {}), ("chunked", dict(chunk_rounds=2)),
                     ("overlap", dict(chunk_rounds=2, overlap=True))):
        eng = FedEngine(algo)
        runs[name] = (eng.run(algo.init_from(st), task, **kw), eng.history)
    first = FedEngine(algo)
    mid = first.run(algo.init_from(st), task, rounds=1)
    first.save_state(str(tmp_path / "llm.msgpack"), mid)
    second = FedEngine(algo)
    restored = second.load_state(str(tmp_path / "llm.msgpack"),
                                 algo.init_from(st))
    assert second.rounds_done == 1
    runs["resumed"] = (second.run(restored, task, rounds=1), second.history)
    for name, (out, hist) in runs.items():
        _equal(out.clients.params, runs["loop"][0].clients.params)
        assert hist == runs["loop"][1], name
    # an explicit start_round from the round-1 state draws round 1's o_r
    third = FedEngine(algo)
    _equal(third.run(mid, task, rounds=1, start_round=1).clients.params,
           runs["loop"][0].clients.params)
    assert third.history == runs["loop"][1][1:]


@pytest.mark.parametrize("codec,expected", [
    ("fp16", lambda cm: cm.dsfl_fp16_round()),
    ("topk", lambda cm: cm.dsfl_topk_round(8))])
def test_measured_dsfl_bytes_match_comm_model(port, codec, expected):
    """Per-token payloads: |o_r| * S distributions a client."""
    task, st = port
    algo = _dsfl(topk=8 if codec == "topk" else None)
    c = (wire.TopKCodec(k=8, n_classes=CFG.vocab) if codec == "topk"
         else wire.FP16Codec())
    eng = FedEngine(algo, codec=c)
    cm = CommModel(K, CFG.vocab, 0, open_batch=B * S)
    assert eng.measured_round_bytes(algo.init_from(st), task) == expected(cm)


def test_measured_fedavg_bytes_match_comm_model(port):
    task, st = port
    algo = LLMFedAvgAlgorithm(CFG, LLMFedAvgHP(), device=CPU)
    n = sum(v[0].numel() for v in st.values())
    assert FedEngine(algo).measured_round_bytes(algo.init_from(st), task) \
        == CommModel(K, CFG.vocab, n).fl_round()


def test_sim_runner_sparse_rounds_equal_dense_masked(port):
    """Through `SimRunner` at half participation: the sparse rounds
    (``active_budget="auto"``, one lane of two) equal the dense masked
    rounds on the same plans, bitwise, and both touch one client a round."""
    task, st = port
    outs = {}
    for budget in ("auto", None):
        algo = _dsfl(use_kernel=True)
        runner = SimRunner(FedEngine(algo), SyncScheduler(
            ClientPopulation.lognormal(0, K), fraction=0.5), seed=0)
        outs[budget] = (runner.run(algo.init_from(st), task, rounds=2,
                                   active_budget=budget), runner.history)
    _equal(outs["auto"][0].clients.params, outs[None][0].clients.params)
    assert [r["participants"] for r in outs["auto"][1].records] == [1, 1]
    assert outs["auto"][1].records == outs[None][1].records
