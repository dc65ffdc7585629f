"""Tensor parallelism over "model" and FSDP over "data" for the dense LLM
family (`repro_torch.launch.tp`) over ``torch.distributed`` ranks (gloo on
the CPU), against the same rounds in one process and against the
reference's `repro.core.llm_dsfl` rounds.

Worlds, each spawned once by a module fixture (`launch.pod_check`'s
cases; K = 2, batch 2, seq 32, lr 5e-3, float32, the plain routes):

  * "tp": qwen1.5-4b's smoke config (4 heads of 32, QKV bias, vocabulary
    512) on (1, 1, 2): attention, MLP and vocabulary split over "model";
  * "gqa": phi3-medium-14b's smoke config cut to grouped-query heads (4
    over 2) and a 16-token window, on (1, 1, 2);
  * "fsdp": qwen's on (1, 2, 1): every d_model dimension over "data",
    each data rank on one of the two sequences;
  * "pod_tp": qwen's on (2, 1, 2): one client a pod, "model" inside it;
  * "odd": qwen's with 6 query heads over 3 key/value heads (the
    `attn_tp == False` branch: attention replicated on "model"), d_ff 255
    (the MLP replicated), vocabulary 500 padded to 512 (split, the padded
    columns masked on global indices), on (1, 2, 2), from the keyed init.

The first four start from the reference's client-stacked init, which each
rank loads with ``shardings=``.  Held: each rank's leaves are exactly
`local_slice` of the one-process leaves under ``param_specs`` before any
round; after each case within the tolerances of tests/test_torch_dense_
train.py (leaves and loss atol 1e-5 after one round, 1e-4 after two; loss
rtol 1e-6) against the one-process port and the reference, each leaf
of the one-process round moved past that bound; a fault planted in one
rank's slice before a round shown to fail the check; the collectives log, per axis, equal to `tp.round_bytes`' closed form; the
sharded checkpoint gathered whole, read by the reference's reader; the
trainer's ``--world 4`` at K = 2 on (2, 1, 2); the audio and VLM families
refused on a mesh that splits "data" or "model", the ssm, moe and hybrid
families planned on one (their rounds: tests/test_torch_tp_families.py)."""
import dataclasses
import functools
from types import SimpleNamespace

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
from repro_torch.configs import get_config, list_archs
from repro_torch.core.algorithms import ClientState, RoundState
from repro_torch.core.engine import FedEngine, open_batch
from repro_torch.core.llm_algorithms import LLMDSFLAlgorithm
from repro_torch.core.llm_dsfl import LLMDsflHP
from repro_torch.data.pipeline import build_lm_task
from repro_torch.launch import dist, tp, train
from repro_torch.launch.pod_check import (CASES, FAULT_LEAF, FAULT_RANK,
                                          DrillSpec, rank_main, run_cases)
from repro_torch.launch.mesh import client_mesh_shape
from repro_torch.launch.roofline import axis_bytes
from repro_torch.launch.sharding import (Ruler, local_slice, mesh_coords,
                                         model_shapes, param_specs)
from repro_torch.models import shardctx

from test_torch_convert import flat_ref, to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

K, B, S, LR = 2, 2, 32, 5e-3
ROUND_TOL = {1: 1e-5, 2: 1e-4}
QWEN, PHI3 = "qwen1.5-4b", "phi3-medium-14b"
GQA = (("n_heads", 4), ("n_kv_heads", 2), ("sliding_window", 16))
ODD = (("n_heads", 6), ("n_kv_heads", 3), ("d_ff", 255), ("vocab", 500),
       ("pad_vocab", 512))
WORLDS = {
    "tp": (QWEN, (), (1, 1, 2), ("load", "era", "era_overlap", "topk",
                                 "sparse", "fedavg", "ckpt")),
    "gqa": (PHI3, GQA, (1, 1, 2), ("load", "dsfl", "topk", "sparse",
                                   "fedavg")),
    "fsdp": (QWEN, (), (1, 2, 1), ("load", "era", "topk", "sparse",
                                   "fedavg", "ckpt")),
    "pod_tp": (QWEN, (), (2, 1, 2), ("load", "era", "topk", "sparse",
                                     "fedavg")),
    "odd": (QWEN, ODD, (1, 2, 2), ("load", "dsfl", "fedavg")),
}
FROM_REFERENCE = ("tp", "gqa", "fsdp", "pod_tp")
ROUNDS = {c: v[1] for c, v in CASES.items()}
# the cases whose reference rounds are another case's: the sparse round
# is bitwise its dense masked one, the pipelined schedule the loop's
SAME_REF = {"era_overlap": "era", "ckpt": "dsfl", "sparse": "masked"}


def stand_in(shape):
    return SimpleNamespace(axis_names=("pod", "data", "model"),
                           devices=np.empty(shape))


def _configs(arch, overrides):
    kw = dict(overrides)
    return (jget_config(arch).smoke().replace(**kw),
            get_config(arch).smoke().replace(**kw))


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
    """Per world: the reference's init (where used), the cases in one
    process and over the spawned ranks."""
    out = {}
    for name, (arch, over, shape, cases) in WORLDS.items():
        tmp = tmp_path_factory.mktemp(name)
        jcfg, cfg = _configs(arch, over)
        jst, init_path = None, None
        if name in FROM_REFERENCE:
            jst = jax.jit(jax.vmap(lambda k: japi.model_init(jcfg, k)))(
                jax.random.split(jax.random.PRNGKey(len(name)), K))
            init_path = str(tmp / "init.msgpack")
            FedEngine(LLMDSFLAlgorithm(cfg, LLMDsflHP(), device="cpu")
                      ).save_state(init_path, RoundState(
                          clients=ClientState(params=to_port(jst))))
        spec = DrillSpec(arch=arch, overrides=over, mesh_shape=shape,
                         clients=K, batch=B, seq=S, lr=LR, cases=cases,
                         init_path=init_path, out_dir=str(tmp))
        out[name] = dict(
            jst=jst, tmp=tmp, spec=spec, cfg=cfg, jcfg=jcfg, shape=shape,
            one=run_cases(spec),
            ranks=dist.spawn(rank_main, int(np.prod(shape)), spec))
    return out


def _specs(w) -> dict:
    """The client-stacked spec of every leaf on the world's mesh."""
    return param_specs(w["cfg"], model_shapes(w["cfg"], lead=(K,)),
                       stand_in(w["shape"]), client_axis="pod")


def _cases(with_load=True):
    return [(n, c) for n, (_, _, _, cases) in WORLDS.items() for c in cases
            if with_load or c != "load"]


# ------------------------------------------------------------- layout ----
@pytest.mark.parametrize("world", list(WORLDS))
def test_each_rank_holds_local_slice_of_every_leaf(worlds, world):
    """Before any round (the keyed init, or the reference's init loaded
    with ``shardings=``): rank r's leaf is `local_slice` of the whole one
    under ``param_specs``, exactly, for every leaf and rank."""
    w = worlds[world]
    specs, mesh = _specs(w), stand_in(w["shape"])
    one = w["one"]["load"]["params"]
    for r, rank in enumerate(w["ranks"]):
        got = rank["load"]["params"]
        assert set(got) == set(one)
        for k, v in one.items():
            assert torch.equal(got[k], local_slice(v, specs[k], mesh, r)), \
                (world, r, k)


def test_the_worlds_split_what_they_claim(worlds):
    """The rules' choices the worlds are meant to exercise."""
    split = {n: Ruler(w["cfg"], stand_in(w["shape"]))
             for n, w in worlds.items()}
    assert split["tp"].attn_tp and split["gqa"].attn_tp
    assert not split["odd"].attn_tp and split["odd"].q_tp
    assert split["odd"].M(255) is None and split["odd"].M(512) == "model"
    assert worlds["gqa"]["cfg"].n_kv_heads < worlds["gqa"]["cfg"].n_heads
    specs = _specs(worlds["fsdp"])
    assert specs["blocks/s0_mix/wq"] == ("pod", None, "data", None)
    assert specs["embed/tok"] == ("pod", None, "data")
    specs = _specs(worlds["odd"])
    assert specs["blocks/s0_mix/wq"] == ("pod", None, "data", None)
    assert specs["blocks/s0_ffn/w_down"] == ("pod", None, None, "data")
    assert specs["embed/tok"] == ("pod", "model", "data")


# ----------------------------------------------------- vs one process ----
def _whole(w, case) -> dict:
    """The ranks' slices of every leaf put back together (each slice
    written where `local_slice` cuts it)."""
    specs, mesh = _specs(w), stand_in(w["shape"])
    one = w["one"]["load"]["params"]
    out = {k: torch.full_like(v, float("nan")) for k, v in one.items()}
    for r, rank in enumerate(w["ranks"]):
        for k, v in rank[case]["params"].items():
            local_slice(out[k], specs[k], mesh, r).copy_(v)
    return out


@pytest.mark.parametrize("world,case", _cases(with_load=False))
def test_rounds_match_one_process(worlds, world, case):
    w = worlds[world]
    tol = ROUND_TOL[ROUNDS[case]]
    one = w["one"][case]
    got = _whole(w, case)
    for k, v in one["params"].items():
        assert not got[k].isnan().any(), k
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=tol,
                                   rtol=0, err_msg=k)
    for rank in w["ranks"]:
        hist = rank[case]["history"]
        assert [h["round"] for h in hist] == [h["round"] for h in
                                              one["history"]]
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in one["history"]],
                                   rtol=1e-6, atol=tol)


@pytest.mark.parametrize("world,case", _cases(with_load=False))
def test_every_leaf_moves_past_the_bound(worlds, world, case):
    """Each case's one-process round moves every leaf by more than the
    bound the ranks are held to, so the comparison sees a round gone
    wrong anywhere."""
    moved = worlds[world]["one"][case]["moved"]
    least = min(moved, key=moved.get)
    assert moved[least] > ROUND_TOL[ROUNDS[case]], (least, moved[least])


@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 1)])
def test_a_fault_planted_in_one_rank_fails_the_check(shape):
    """Rank `FAULT_RANK`'s ``w_down`` slice 1% off before a FedAvg round:
    the ranks' slices leave the one-process bound (`compare_slices`)."""
    spec = DrillSpec(mesh_shape=shape, clients=K, batch=B, seq=S, lr=LR,
                     cases=("fedavg",), keep_values=("fedavg",))
    one = run_cases(spec)
    refs = {"fedavg": one["fedavg"]["values"]}
    ranks = dist.spawn(rank_main, 2, dataclasses.replace(
        spec, keep_values=(), fault=True), refs)
    worst = [max(rk["fedavg"]["max_abs"].values()) for rk in ranks]
    assert max(worst) > 100 * ROUND_TOL[1], worst
    assert ranks[FAULT_RANK]["fedavg"]["max_abs"][FAULT_LEAF] > ROUND_TOL[1]


def test_pod_ranks_of_a_model_column_hold_the_same_fedavg_mean(worlds):
    """(2, 1, 2): the "pod" all-reduce of FedAvg leaves both pods of a
    "model" column with the same bits."""
    ranks = worlds["pod_tp"]["ranks"]
    mesh = stand_in((2, 1, 2))
    for r, rank in enumerate(ranks):
        c = mesh_coords(mesh, r)
        if c["pod"]:
            continue
        twin = ranks[r + 2]
        for k, v in rank["fedavg"]["params"].items():
            assert torch.equal(v, twin["fedavg"]["params"][k]), (r, k)


# --------------------------------------------------------- reference ----
@functools.lru_cache(maxsize=None)
def _ref_step(arch, overrides, kind, topk, weighted):
    jcfg, _ = _configs(arch, overrides)
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


def _ref_case(name, w, case):
    """The reference's rounds of ``case`` from world ``name``'s init."""
    arch, over, _, _ = WORLDS[name]
    kind, rounds, _, hp_kw, plan, _ = CASES[case]
    odd = np.arange(K) % 2
    mask, stale = np.ones(K, np.float32), np.zeros(K, np.int32)
    if plan == "half":
        mask = (1 - odd).astype(np.float32)
    weights = jagg.participation_weights(jnp.asarray(mask),
                                         jnp.asarray(stale), 0.5)
    step = _ref_step(arch, over, kind, hp_kw.get("topk"), plan is not None)
    task = build_lm_task(0, K, B, S, w["cfg"].vocab, device="cpu")
    pb = {"tokens": jnp.asarray(task.x_clients["tokens"].numpy(), jnp.int32)}
    open_all = task.open_x["tokens"].numpy()
    st, losses = w["jst"], []
    for r in range(rounds):
        o = open_batch(0, r, B, B, "cpu").numpy()
        st, loss = step(st, pb, {"tokens": jnp.asarray(open_all[o],
                                                       jnp.int32)},
                        weights, jnp.asarray(mask))
        losses.append(float(loss))
    return st, losses


@pytest.fixture(scope="module")
def refs(worlds):
    out = {}
    for name in FROM_REFERENCE:
        w = worlds[name]
        out[name] = {c: _ref_case(name, w, c) for c in
                     {SAME_REF.get(c, c) for c in WORLDS[name][3]}
                     if c != "load"}
    return out


@pytest.mark.parametrize("world,case", [
    (n, c) for n, c in _cases(with_load=False) if n in FROM_REFERENCE])
def test_rounds_match_reference(worlds, refs, world, case):
    w = worlds[world]
    jst, losses = refs[world][SAME_REF.get(case, case)]
    tol = ROUND_TOL[ROUNDS[case]]
    got, ref = _whole(w, case), flat_ref(jst)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=tol, rtol=0,
                                   err_msg=k)
    hist = w["ranks"][0][case]["history"]
    np.testing.assert_allclose([h["loss"] for h in hist], losses,
                               rtol=1e-6, atol=tol)


# -------------------------------------------------------- collectives ----
def _lanes_run(w, case, rank) -> int:
    """The rank's lanes that predict and train in a round of ``case``."""
    P = w["shape"][0]
    n = K // P
    lo = mesh_coords(stand_in(w["shape"]), rank)["pod"] * n
    if CASES[case][5]:          # the sparse plan: the even clients
        return sum(1 for k in range(lo, lo + n) if k % 2 == 0)
    return n


@pytest.mark.parametrize("world,case", _cases(with_load=False))
def test_collective_bytes_per_axis_are_the_closed_form(worlds, world, case):
    """Every rank's log, summed per mesh axis and kind, equals
    `tp.round_bytes` times the case's rounds (the blocks' recompute
    repeating their forward collectives)."""
    w = worlds[world]
    kind, rounds, _, hp_kw, _, _ = CASES[case]
    for r, rank in enumerate(w["ranks"]):
        want = tp.round_bytes(w["cfg"], w["shape"], clients=K, batch=B,
                              seq=S, mode=kind,
                              lanes_run=_lanes_run(w, case, r),
                              topk=hp_kw.get("topk"))
        want = tp.merge((want, rounds))
        assert axis_bytes(rank[case]["log"]) == want, (world, r)
    assert w["one"][case]["log"] == []


def test_closed_form_reads_the_rules():
    """`tp.pass_bytes` at phi3-medium-14b's full width on (2, 1, 2): the
    row-parallel reduces of attention and the MLP and the vocabulary's
    gather, each (B*S, d) or (B*S, V) in bf16, nothing over "data"; on
    (1, 2, 1) every block leaf's gather twice in a grad pass."""
    cfg = get_config(PHI3).replace(n_layers=4)
    rows, act = 8 * 128, 8 * 128 * 5120 * 2
    fwd = tp.pass_bytes(cfg, (2, 1, 2), rows, False)
    assert fwd == {"model": {"all-reduce": act + 4 * 2 * act,
                             "all-gather": rows * 100_352 * 2}}
    grad = tp.pass_bytes(cfg, (2, 1, 2), rows, True)
    assert grad["model"]["all-reduce"] == act + 4 * 2 * act \
        + 2 * 4 * 2 * act + act
    block = 5120 * (5120 + 2 * 1280 + 5120 + 3 * 17920) * 2
    fsdp = tp.pass_bytes(cfg, (1, 2, 1), rows, True)["data"]
    assert fsdp["all-gather"] == 100_352 * 5120 * 2 + 2 * 4 * block
    assert fsdp["reduce-scatter"] == (100_352 * 5120 * 2 + 4 * block) // 2
    assert fsdp["all-reduce"] == 4 * (2 * 4 * 5120 + 5120)


# --------------------------------------------------------- checkpoint ----
@pytest.mark.parametrize("world", ["tp", "fsdp"])
def test_sharded_checkpoint_is_whole_and_read_by_the_reference(worlds,
                                                               world):
    """Rank 0 writes the leaves gathered whole over "model" and "data":
    the reference's reader reads them, equal to the ranks' slices put
    together, and a one-process engine loads the file."""
    w = worlds[world]
    path = w["tmp"] / "pod2.msgpack"
    whole = _whole(w, "ckpt")
    raw = jload_pytree(str(path))
    leaves = [np.asarray(x) for x in raw["leaves"]]
    names = sorted(whole, key=lambda k: tuple(k.split("/")))
    assert len(leaves) == len(names)
    ref = flat_ref(jax.tree.map(lambda a: a, w["jst"]))
    for got, k in zip(leaves, names):
        assert got.shape == ref[k].shape, k
        np.testing.assert_array_equal(got, whole[k].numpy(), err_msg=k)
    eng = FedEngine(LLMDSFLAlgorithm(w["cfg"], LLMDsflHP(), device="cpu"))
    like = RoundState(clients=ClientState(params=to_port(w["jst"])))
    state = eng.load_state(str(path), like)
    assert eng.rounds_done == 1
    for k, v in whole.items():
        assert torch.equal(state.clients.params[k], v), k


# ------------------------------------------------------------ refusals ----
SPLIT_FAMILIES = ("ssm", "moe", "hybrid")
# a Mamba2 config whose 3 heads "model" of 2 cannot split, while its
# d_inner of 96 splits: the rules would cut a head in two
CUT_MIXER = (("d_model", 48),)


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get_config(a).arch_type
                                  not in ("dense",) + SPLIT_FAMILIES])
@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 1)])
def test_other_families_refuse_a_data_or_model_axis(arch, shape):
    """The audio and VLM families no longer refuse: `tp.plan_for` builds on
    a fake world of the mesh's size, and its flags say what the rules
    split (attention's heads, the MLP's columns, the projector's columns
    over "model"; tests/test_torch_tp_modality.py runs them).  A Mamba2
    mixer cut inside a head is what `check_family` still refuses."""
    from repro_torch.launch import dryrun
    cfg = get_config(arch).smoke()
    try:
        plan = tp.plan_for(cfg, dryrun.fake_world(device="cpu", shape=shape))
    finally:
        dryrun.close_world()
    split = shape[2] > 1
    assert (plan.attn_tp, plan.mlp_tp, plan.vocab_tp) == (split,) * 3
    assert plan.proj_tp == (split and cfg.arch_type == "vlm")
    assert not (plan.ssm_tp or plan.ep)
    assert (plan.data.size, plan.model.size) == shape[1:]
    mamba = get_config("mamba2-2.7b").smoke().replace(**dict(CUT_MIXER))
    with pytest.raises(NotImplementedError, match="cut in two"):
        tp.check_family(mamba, stand_in((1, 1, 2)))
    tp.check_family(mamba, stand_in((2, 1, 1)))      # the client axis runs


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get_config(a).arch_type
                                  in SPLIT_FAMILIES])
@pytest.mark.parametrize("shape", [(1, 1, 2), (1, 2, 1)])
def test_the_mixer_and_moe_families_take_a_data_or_model_axis(arch, shape):
    """`tp.plan_for` builds on a fake world of the mesh's size, and its
    flags say what the rules split: the Mamba2 heads and the experts over
    "model", nothing of them over "data" alone."""
    from repro_torch.launch import dryrun
    cfg = get_config(arch).smoke()
    mixers = {m for m, _ in cfg.pattern}
    ffns = {f for _, f in cfg.pattern}
    try:
        plan = tp.plan_for(cfg, dryrun.fake_world(device="cpu", shape=shape))
    finally:
        dryrun.close_world()
    split = shape[2] > 1
    assert plan.ssm_tp == (split and "mamba" in mixers)
    assert plan.ep == (split and "moe" in ffns)
    assert plan.attn_tp == (split and "attn" in mixers)
    assert (plan.data.size, plan.model.size) == shape[1:]


def test_a_non_dense_model_on_a_model_mesh_stops_the_spawn():
    """A Mamba2 mixer the rules would cut inside a head (`CUT_MIXER`) is
    refused on every rank, and the spawn raises instead of waiting."""
    from torch.multiprocessing import ProcessRaisedException
    with pytest.raises(ProcessRaisedException, match="NotImplementedError"):
        dist.spawn(rank_main, 2, DrillSpec(arch="mamba2-2.7b",
                                           overrides=CUT_MIXER,
                                           mesh_shape=(1, 1, 2),
                                           cases=("dsfl",)))


def test_no_plan_without_a_split_axis():
    assert shardctx.current_plan() is None
    assert shardctx.gather_vocab(t := torch.ones(2, 3)) is t
    assert shardctx.gather_top(p := {"embed/tok": t}) is p
    assert shardctx.gather_block(p) is p


# ------------------------------------------------------------ trainer ----
def _rounds(out):
    return [(l.split()[1], float(l.split()[3])) for l in out.splitlines()
            if l.startswith("round")]


@pytest.mark.parametrize("mode", ["dsfl", "fedavg"])
def test_trainer_world_four_runs_k2_on_pod_and_model(capfd, mode):
    """``--world 4`` at K = 2: the client mesh (2, 1, 2), each client's
    leaves split over "model"; rank 0 prints the one-process losses."""
    argv = ["--smoke", "--device", "cpu", "--steps", "1", "--mode", mode]
    train.main(argv)
    one = capfd.readouterr().out
    train.main(argv + ["--world", "4", "--backend", "gloo"])
    four = capfd.readouterr().out
    assert _rounds(one) and len(_rounds(four)) == len(_rounds(one))
    for (r1, l1), (r4, l4) in zip(_rounds(one), _rounds(four)):
        assert r1 == r4 and abs(l1 - l4) <= 1e-4 + 1e-6 * abs(l1)
    # rank 0 prints the whole model's count and the one-process bytes
    # (FedAvg's measured payload: the client's leaves gathered whole)
    head = [l for l in one.splitlines() if l.startswith(("params/",
                                                          "exchange/"))]
    assert head and [l for l in four.splitlines()
                     if l.startswith(("params/", "exchange/"))] == head
    assert client_mesh_shape(4, 2) == (2, 1, 2)
