"""The federated client axis over ``torch.distributed`` ranks (gloo on the
CPU): every LLM round kind of `repro_torch.launch.pod_check` over a world
of 2 and a world of 4 ranks (one client a rank), against the same rounds
in one process and against the reference's `repro.core.llm_dsfl` rounds.

qwen1.5-4b's smoke config (2 layers, d 128, vocabulary 512, float32), K =
world, batch 2, seq 32, lr 5e-3, the plain routes, from the reference's
client-stacked init (written once by the one-process engine and loaded by
each rank with ``shardings=``).  Each world is spawned once, by a module
fixture, and writes nothing but its results and its checkpoint.

Held: at P = 2 every case bitwise the one-process port (parameters,
history on every rank); at P = 4 the same but for FedAvg's dense mean,
whose all-reduce sums the four f32 terms in the backend's order: within 4
float32 ulps of each leaf's largest magnitude.  Against the reference, the
tolerances of tests/test_torch_llm_algorithms.py: leaves after one round
at atol 1e-5, after two at 1e-4, the loss at rtol 1e-6 and that atol.
The collectives log equals its closed form: DS-FL K*B*S*V*2 bytes a round
(top-k K*B*S*k*8), FedAvg 4 bytes a parameter, and 4*K for the losses.
Then the checkpoint both ways, the trainer's ``--world``, the example."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jload_pytree
from repro.configs import get_config as jget_config
from repro.core import aggregation as jagg
from repro.core import llm_dsfl as J
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.convert import flatten_tree
from repro_torch.core.algorithms import ClientState, RoundState
from repro_torch.core.engine import FedEngine, open_batch
from repro_torch.core.llm_algorithms import LLMDSFLAlgorithm
from repro_torch.core.llm_dsfl import LLMDsflHP
from repro_torch.data.pipeline import build_lm_task
from repro_torch.launch import dist, train
from repro_torch.launch.pod_check import CASES, DrillSpec, rank_main, run_cases
from repro_torch.launch.roofline import collective_bytes, cross_pod_bytes

from test_torch_convert import flat_ref, to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401
from test_torch_examples import load

ARCH = "qwen1.5-4b"
B, S, LR = 2, 32, 5e-3
WORLDS = (2, 4)
ROUND_TOL = {1: 1e-5, 2: 1e-4}
ULPS = 4 * 2.0 ** -23
NOT_BITWISE = {4: ("fedavg",)}     # the dense FedAvg mean at P = 4
ROUNDS = {c: v[1] for c, v in CASES.items()}


def _spec(world, tmp):
    return DrillSpec(arch=ARCH, clients=world, batch=B, seq=S, lr=LR,
                     init_path=str(tmp / "init.msgpack"), out_dir=str(tmp))


@pytest.fixture(scope="module", autouse=True)
def one_thread_ranks():
    """Each spawned rank starts on one intra-op thread, as this process
    runs (`one_intra_op_thread`)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("MKL_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Per world size: the reference's init, the cases in one process and
    over the spawned ranks (gloo, CPU)."""
    jcfg = jget_config(ARCH).smoke()
    cfg = get_config(ARCH).smoke()
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"pod{world}")
        jst = jax.jit(jax.vmap(lambda k: japi.model_init(jcfg, k)))(
            jax.random.split(jax.random.PRNGKey(world), world))
        eng = FedEngine(LLMDSFLAlgorithm(cfg, LLMDsflHP(), device="cpu"))
        eng.save_state(str(tmp / "init.msgpack"),
                       RoundState(clients=ClientState(params=to_port(jst))))
        spec = _spec(world, tmp)
        out[world] = dict(jst=jst, tmp=tmp, spec=spec, one=run_cases(spec),
                          pod=dist.spawn(rank_main, world, spec))
    return out


def _cat(pod, case) -> dict:
    """The ranks' lanes of every leaf, in client order."""
    return {k: torch.cat([r[case]["params"][k] for r in pod])
            for k in pod[0][case]["params"]}


# ------------------------------------------------ pod vs one process ----
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("world", WORLDS)
def test_pod_rounds_bitwise_one_process(worlds, world, case):
    w = worlds[world]
    one, pod = w["one"][case], w["pod"]
    for r in pod:
        assert r[case]["history"] == one["history"]
    got = _cat(pod, case)
    assert set(got) == set(one["params"])
    for k, v in one["params"].items():
        if case in NOT_BITWISE.get(world, ()):
            tol = ULPS * float(v.abs().max())
            assert float((got[k] - v).abs().max()) <= tol, k
        else:
            assert torch.equal(got[k], v.contiguous()), k


def test_fedavg_at_four_ranks_is_not_trivially_equal(worlds):
    """What the stated tolerance covers: the four-term all-reduce does
    move some last bits of the dense FedAvg mean."""
    one, got = worlds[4]["one"]["fedavg"]["params"], _cat(worlds[4]["pod"],
                                                          "fedavg")
    assert any(not torch.equal(got[k], v.contiguous())
               for k, v in one.items())


# --------------------------------------------------------- reference ----
@functools.lru_cache(maxsize=None)
def _ref_step(kind, topk, weighted):
    """The reference's round as one jitted program per (kind, top-k,
    weighted): the participation weights and mask are its arguments, so
    the weighted and the masked cases share a compile."""
    jcfg = jget_config(ARCH).smoke()
    if kind == "dsfl":
        hp = J.LLMDsflHP(lr=LR, topk=topk)
        fn = lambda p, a, b, w, m: J.dsfl_round_step(
            jcfg, p, a, b, hp, **({"weights": w, "mask": m} if weighted
                                  else {}))
    else:
        fn = lambda p, a, b, w, m: J.fedavg_round_step(
            jcfg, p, a, LR, **({"weights": w, "mask": m} if weighted
                               else {}))
    return jax.jit(fn)


def _ref_case(jst, task, world, case):
    """The reference's rounds of ``case`` from ``jst``: (state, losses)."""
    kind, rounds, _, hp_kw, plan, _ = CASES[case]
    K = world
    odd = np.arange(K) % 2
    mask, stale = np.ones(K, np.float32), np.zeros(K, np.int32)
    if plan == "stale":
        stale = odd.astype(np.int32)
    elif plan == "half":
        mask = (1 - odd).astype(np.float32)
    w = jagg.participation_weights(jnp.asarray(mask), jnp.asarray(stale), 0.5)
    step = _ref_step(kind, hp_kw.get("topk"), plan is not None)
    pb = {"tokens": jnp.asarray(task.x_clients["tokens"].numpy(), jnp.int32)}
    open_all = task.open_x["tokens"].numpy()
    st, losses = jst, []
    for r in range(rounds):
        o = open_batch(0, r, B, B, "cpu").numpy()
        st, loss = step(st, pb, {"tokens": jnp.asarray(open_all[o],
                                                       jnp.int32)},
                        w, jnp.asarray(mask))
        losses.append(float(loss))
    return st, losses


# the cases whose reference rounds are another case's: the sparse rounds
# are bitwise their dense masked ones, the split schedules the loop's
SAME_REF = {"era_chunk": "era", "era_overlap": "era", "ckpt": "dsfl",
            "sparse": "masked"}


@pytest.fixture(scope="module")
def refs(worlds):
    cfg = get_config(ARCH).smoke()
    out = {}
    for world, w in worlds.items():
        task = build_lm_task(0, world, B, S, cfg.vocab, device="cpu")
        out[world] = {c: _ref_case(w["jst"], task, world, c)
                      for c in CASES if c not in SAME_REF}
    return out


@pytest.mark.parametrize("case", [c for c in CASES if c != "load"])
@pytest.mark.parametrize("world", WORLDS)
def test_pod_rounds_match_reference(worlds, refs, world, case):
    jst, losses = refs[world][SAME_REF.get(case, case)]
    tol = ROUND_TOL[ROUNDS[case]]
    got = _cat(worlds[world]["pod"], case)
    ref = flat_ref(jst)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=tol, rtol=0,
                                   err_msg=k)
    hist = worlds[world]["pod"][0][case]["history"]
    np.testing.assert_allclose([h["loss"] for h in hist], losses,
                               rtol=1e-6, atol=tol)


def test_sharded_load_gives_each_rank_its_lanes(worlds):
    for world, w in worlds.items():
        init = to_port(w["jst"])
        for r, rank in enumerate(w["pod"]):
            for k, v in rank["load"]["params"].items():
                assert torch.equal(v, init[k][r:r + 1]), (world, r, k)


# -------------------------------------------------------- collectives ----
def _closed_form(world, case, n_params) -> list:
    """The log a case's rounds must leave on every rank."""
    K, pod = world, ("pod",)
    losses = ("all-gather", pod, 4 * K)
    kind, rounds, _, hp_kw, _, _ = CASES[case]
    if kind == "fedavg":
        return [losses, ("all-reduce", pod, 4 * n_params)] * rounds
    if hp_kw.get("topk"):
        pairs = ("all-gather", pod, K * B * S * hp_kw["topk"] * 4)
        return [pairs, pairs, losses] * rounds
    V = get_config(ARCH).smoke().eff_vocab
    return [("all-gather", pod, K * B * S * V * 2), losses] * rounds


@pytest.mark.parametrize("case", [c for c in CASES if c != "load"])
@pytest.mark.parametrize("world", WORLDS)
def test_collectives_log_closed_form(worlds, world, case):
    n_params = sum(v[0].numel() for v in
                   worlds[world]["one"]["load"]["params"].values())
    want = _closed_form(world, case, n_params)
    for rank in worlds[world]["pod"]:
        log = rank[case]["log"]
        if CASES[case][0] == "fedavg":
            # one all-reduce a leaf: their bytes sum to the parameters'
            ar = collective_bytes(e for e in log if e[0] == "all-reduce")
            log = [e for e in log if e[0] != "all-reduce"]
            log.insert(1, ("all-reduce", ("pod",), ar["all-reduce"]))
        assert log == want
        assert cross_pod_bytes(rank[case]["log"]) == collective_bytes(
            rank[case]["log"])
    assert worlds[world]["one"][case]["log"] == []


def test_top_k_exchange_is_below_the_dense_one(worlds):
    for world, w in worlds.items():
        dense = sum(cross_pod_bytes(w["pod"][0]["dsfl"]["log"]).values())
        topk = sum(cross_pod_bytes(w["pod"][0]["topk"]["log"]).values())
        assert topk * 8 < dense, world


# --------------------------------------------------------- checkpoint ----
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_save_is_the_one_process_file(worlds, world):
    """Rank 0 writes the gathered state: byte for byte the one-process
    file, which a one-process engine and the reference both read."""
    tmp = worlds[world]["tmp"]
    pod_file, one_file = tmp / f"pod{world}.msgpack", tmp / "one.msgpack"
    assert pod_file.read_bytes() == one_file.read_bytes()
    cfg = get_config(ARCH).smoke()
    eng = FedEngine(LLMDSFLAlgorithm(cfg, LLMDsflHP(), device="cpu"))
    like = RoundState(clients=ClientState(params=to_port(
        worlds[world]["jst"])))
    state = eng.load_state(str(pod_file), like)
    one = worlds[world]["one"]["ckpt"]
    assert eng.rounds_done == 1 and eng.history == one["history"]
    for k, v in one["params"].items():
        assert torch.equal(state.clients.params[k], v.contiguous()), k
    raw = jload_pytree(str(pod_file))
    leaves = [np.asarray(x) for x in raw["leaves"]]
    want = flatten_tree({k: v.numpy() for k, v in sorted(
        one["params"].items(), key=lambda kv: tuple(kv[0].split("/")))})
    assert len(leaves) == len(want)
    for got, v in zip(leaves, want.values()):
        np.testing.assert_array_equal(got, v)


# ----------------------------------------------------------- entry points --
def test_rank_without_a_card_raises():
    if torch.cuda.is_available():
        assert dist.rank_device("cuda", 0).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist.rank_device("cuda", 0)


def test_trainer_world_two_matches_one_process(capfd):
    argv = ["--smoke", "--device", "cpu", "--steps", "1"]
    train.main(argv)
    one = capfd.readouterr().out
    train.main(argv + ["--world", "2", "--backend", "gloo"])
    two = capfd.readouterr().out
    line = lambda out: [l.split("  ")[:2] for l in out.splitlines()
                        if l.startswith("round")]
    assert line(one) and line(two) == line(one)
    assert two.count("params/client: 394,624") == 1      # rank 0 prints


def test_multi_pod_comm_example(capsys):
    load("torch_multi_pod_comm").main(["--smoke", "--device", "cpu",
                                       "--world", "2"])
    out = capsys.readouterr().out.splitlines()
    rows = {l.split()[0]: l for l in out
            if l.split() and l.split()[0].endswith("_round")}
    assert set(rows) == {"dsfl_round", "fedavg_round"}
    assert "CommModel (K uploads + 1 broadcast)" in rows["dsfl_round"]
    assert any(l.startswith("DS-FL round moves") and "fewer" in l
               for l in out)



def test_a_model_axis_over_ranks_raises_and_stops_the_spawn():
    """Three clients over two ranks put the ranks on "model" (the
    reference's client mesh (1, 1, 2)): a Mamba2 mixer whose 3 heads that
    axis would cut in two (its d_inner of 96 splits) is refused by name on
    every rank, and the spawn raises instead of waiting."""
    from torch.multiprocessing import ProcessRaisedException
    with pytest.raises(ProcessRaisedException, match="cut in two"):
        dist.spawn(rank_main, 2, DrillSpec(arch="mamba2-2.7b", clients=3,
                                           overrides=(("d_model", 48),),
                                           cases=("dsfl",)))
