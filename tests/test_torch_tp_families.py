"""Tensor parallelism of the Mamba2 mixer and expert parallelism of the MoE
FFN (`repro_torch.launch.tp`, `models/ssm.py`, `models/moe.py`) over
``torch.distributed`` ranks (gloo on the CPU), against the same rounds in
one process and against the reference's `repro.core.llm_dsfl` rounds.

Worlds, each spawned once (all at once) with its rounds, a fault run and a
decode run in one spawn (`launch.pod_check`'s cases; K = 2, batch 2, seq
32, float32, the plain routes, from the port's keyed init, which the
reference's rounds start from too):

  * "ssm": mamba2-2.7b's smoke config (8 heads of 32, one group of B and
    C, vocabulary 512) on (1, 1, 2): 4 heads a rank, every rank reading
    the one group;
  * "ssm_fsdp": the same on (1, 2, 1): every d_model dimension over
    "data", each data rank on one of the two sequences;
  * "moe": llama4-scout's (4 experts top-1) on (1, 1, 2): 2 experts a
    rank, attention's heads and the vocabulary split too;
  * "maverick": llama4-maverick's (dense and MoE layers alternating) on
    (1, 2, 2): experts over "model", leaves and batch over "data" (16
    tokens a data rank: one routing group of 16);
  * "hybrid": Jamba's cut to one pattern repeat of 8 sub-layers (7
    Mamba, 1 attention, 4 MoE) on (1, 1, 2): 8 groups of one head, 4
    groups a rank.

The learning rates are each world's least at which every leaf of the
one-process round moves past the bound (the routers and Jamba's ``a_log``
move least), and Jamba's rounds are single ones (at two, ``a_log`` would
need 0.3).  Held: each rank's leaves are exactly `local_slice` of the
one-process leaves before any round; after each case within 1e-5 after
one round and 1e-4 after two (loss rtol 1e-6) of the one-process port and
of the reference (ERA and FedAvg); every leaf of the one-process round moved past that
bound; a 1% fault planted in one rank's slice of the family's
`pod_check.fault_leaf` before a FedAvg round caught; each rank's log per
axis equal to `tp.round_bytes`; a greedy decode under the plan equal to
one process in tokens and within 1e-5 of its largest logit, its bytes
`tp.decode_bytes`, a fault in one rank's SSM state caught; one scout MoE
FFN over the "moe" world's ranks equal to one process
(`pod_check.moe_ffn_rank`), its fault caught; the rules' refusals (a head cut in two,
B and C whole beside split heads, heads straddling groups, a data share
of partial routing groups); the dry run's ``decode_32k`` record ``ok`` for
the four architectures."""
import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import aggregation as jagg
from repro.core import llm_dsfl as J
from repro_torch.configs import get_config
from repro_torch.convert import to_numpy_tree
from repro_torch.core.engine import open_batch
from repro_torch.data.pipeline import build_lm_task
from repro_torch.launch import decode_check as dc
from repro_torch.launch import dist, dryrun, pod_check, tp
from repro_torch.launch.pod_check import CASES, DrillSpec, run_cases
from repro_torch.launch.roofline import axis_bytes
from repro_torch.launch.sharding import (Ruler, local_slice, model_shapes,
                                         param_specs)
from repro_torch.models import moe, ssm
from repro_torch.models.shardctx import active_plan

from test_torch_convert import flat_ref
from test_torch_convert import one_intra_op_thread  # noqa: F401

K, B, S = 2, 2, 32
ROUND_TOL = {1: 1e-5, 2: 1e-4}
DECODE_RTOL = 1e-5
MAMBA, SCOUT = "mamba2-2.7b", "llama4-scout-17b-a16e"
MAVERICK, JAMBA = "llama4-maverick-400b-a17b", "jamba-1.5-large-398b"
ONE_REPEAT = (("n_layers", 8),)
# name -> (arch, overrides, mesh, cases, lr)
WORLDS = {
    "ssm": (MAMBA, (), (1, 1, 2), ("load", "era", "topk", "sparse",
                                   "fedavg"), 5e-3),
    "ssm_fsdp": (MAMBA, (), (1, 2, 1), ("load", "era", "fedavg"), 5e-3),
    "moe": (SCOUT, (), (1, 1, 2), ("load", "era", "topk", "fedavg"), 3e-2),
    "maverick": (MAVERICK, (), (1, 2, 2), ("load", "era", "fedavg"), 3e-2),
    "hybrid": (JAMBA, ONE_REPEAT, (1, 1, 2), ("load", "dsfl", "fedavg"),
               1e-1),
}
DECODE_FAULTS = {"ssm": ("state",)}
ROUNDS = {c: v[1] for c, v in CASES.items()}
# the cases held to the reference too (top-k and sparse: to one process)
REF_CASES = ("era", "dsfl", "fedavg")


def stand_in(shape):
    return SimpleNamespace(axis_names=("pod", "data", "model"),
                           devices=np.empty(shape))


def _spec(name) -> DrillSpec:
    arch, over, shape, cases, lr = WORLDS[name]
    return DrillSpec(arch=arch, overrides=over, mesh_shape=shape, clients=K,
                     batch=B, seq=S, lr=lr, cases=cases)


def _decode_spec(name) -> dc.DecodeSpec:
    arch, over, shape, _, _ = WORLDS[name]
    return dc.DecodeSpec(arch=arch, overrides=over, mesh_shape=shape)


def _programs(name) -> tuple:
    """The world's rank programs: its rounds, the fault run (rank
    `FAULT_RANK`'s slice 1% off before a FedAvg round, held to the
    one-process leaves), its greedy decode (and decode faults)."""
    spec = _spec(name)
    fault = dataclasses.replace(spec, cases=("fedavg",), fault=True)
    dspec = _decode_spec(name)
    dspecs = (dspec,) + tuple(dataclasses.replace(dspec, fault=f) for f in
                              DECODE_FAULTS.get(name, ()))
    return spec, fault, dspecs


# the "moe" world's spawn also holds one MoE FFN (`pod_check.moe_ffn_rank`)
MOE_FFN = pod_check.MoEFFNSpec(smoke=True, tokens=64, group=16,
                               mesh_shape=(1, 1, 2))


@pytest.fixture(scope="module", autouse=True)
def one_thread_ranks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("MKL_NUM_THREADS", "1")
        yield


# ------------------------------------------------------------ reference ----
def _ref_case(name, tree, case):
    """The reference's rounds of ``case`` from the client-stacked leaves
    ``tree`` (numpy, the reference's nesting); run in a process of its
    own (`worlds`), so the compiles run side by side."""
    jst = jax.tree.map(jnp.asarray, tree)
    arch, over, _, _, lr = WORLDS[name]
    jcfg = jget_config(arch).smoke().replace(**dict(over))
    kind, rounds, _, hp_kw, plan, _ = CASES[case]
    odd = np.arange(K) % 2
    mask, stale = np.ones(K, np.float32), np.zeros(K, np.int32)
    if plan == "half":
        mask = (1 - odd).astype(np.float32)
    weights = jagg.participation_weights(jnp.asarray(mask),
                                         jnp.asarray(stale), 0.5)
    kw = lambda w, m: {"weights": w, "mask": m} if plan else {}
    if kind == "dsfl":
        hp = J.LLMDsflHP(lr=lr, topk=hp_kw.get("topk"))
        step = jax.jit(lambda p, a, b, w, m: J.dsfl_round_step(
            jcfg, p, a, b, hp, **kw(w, m)))
    else:
        step = jax.jit(lambda p, a, b, w, m: J.fedavg_round_step(
            jcfg, p, a, lr, **kw(w, m)))
    task = build_lm_task(0, K, B, S, jcfg.vocab, device="cpu")
    pb = {"tokens": jnp.asarray(task.x_clients["tokens"].numpy(), jnp.int32)}
    open_all = task.open_x["tokens"].numpy()
    losses = []
    for r in range(rounds):
        o = open_batch(0, r, B, B, "cpu").numpy()
        jst, loss = step(jst, pb, {"tokens": jnp.asarray(open_all[o],
                                                         jnp.int32)},
                         weights, jnp.asarray(mask))
        losses.append(float(loss))
    return flat_ref(jst), losses


# --------------------------------------------------------------- worlds ----
@pytest.fixture(scope="module")
def worlds():
    """Per world: the ranks' records (spawned at once), the one-process
    cases and decode, and the reference's ERA and FedAvg rounds (each
    (config, lr, case) once, compiled in processes of their own
    meanwhile, the longest first: Jamba's DS-FL round takes about a
    minute)."""
    out, refs = {}, {}
    spawn = multiprocessing.get_context("spawn")
    with ThreadPoolExecutor(len(WORLDS)) as threads, \
            ProcessPoolExecutor(4, mp_context=spawn) as procs:
        spawns = {}
        for name in WORLDS:
            spec, fault, dspecs = _programs(name)
            programs = ((pod_check.rank_main_many, ((spec, fault),
                                                    (None, None))),
                        (dc.rank_main, (dspecs, "cpu")))
            if name == "moe":
                programs += tuple((pod_check.moe_ffn_rank, (
                    dataclasses.replace(MOE_FFN, fault=f),))
                    for f in (False, True))
            spawns[name] = threads.submit(
                dist.spawn, dist.rank_programs, int(np.prod(spec.mesh_shape)),
                programs)
        for name in sorted(WORLDS, key=lambda n: WORLDS[n][0] != JAMBA):
            spec, _, dspecs = _programs(name)
            one = run_cases(dataclasses.replace(spec, keep_values=("fedavg",)))
            one["fedavg"]["params"] = one["fedavg"].pop("values")
            tree = to_numpy_tree(one["load"]["params"])
            arch, over, _, _, lr = WORLDS[name]
            for c in sorted(set(spec.cases) & set(REF_CASES)):
                if (arch, over, lr, c) not in refs:
                    refs[arch, over, lr, c] = procs.submit(_ref_case, name,
                                                           tree, c)
            out[name] = dict(spec=spec, cfg=spec.config(), one=one,
                             decode_one=dc.greedy(dspecs[0], dc.init_params(
                                 dspecs[0], "cpu"), "cpu"))
        for name, w in out.items():
            arch, over, _, _, lr = WORLDS[name]
            w["refs"] = {c: f.result() for (a, o, l, c), f in refs.items()
                         if (a, o, l) == (arch, over, lr)}
            recs = spawns[name].result()
            w["ranks"] = [r[0][0] for r in recs]
            w["fault"] = [r[0][1] for r in recs]
            w["decode"] = [r[1] for r in recs]
            w["moe_ffn"] = [r[2:] for r in recs]
    return out


def _specs(w) -> dict:
    return param_specs(w["cfg"], model_shapes(w["cfg"], lead=(K,)),
                       stand_in(w["spec"].mesh_shape), client_axis="pod")


def _cases(with_load=True):
    return [(n, c) for n, v in WORLDS.items() for c in v[3]
            if with_load or c != "load"]


def _whole(w, case) -> dict:
    """The ranks' slices of every leaf put back together."""
    specs, mesh = _specs(w), stand_in(w["spec"].mesh_shape)
    out = {k: torch.full_like(v, float("nan"))
           for k, v in w["one"]["load"]["params"].items()}
    for r, rank in enumerate(w["ranks"]):
        for k, v in rank[case]["params"].items():
            local_slice(out[k], specs[k], mesh, r).copy_(v)
    return out


# ------------------------------------------------------------- layout ----
@pytest.mark.parametrize("world", list(WORLDS))
def test_each_rank_holds_local_slice_of_every_leaf(worlds, world):
    w = worlds[world]
    specs, mesh = _specs(w), stand_in(w["spec"].mesh_shape)
    one = w["one"]["load"]["params"]
    for r, rank in enumerate(w["ranks"]):
        got = rank["load"]["params"]
        assert set(got) == set(one)
        for k, v in one.items():
            assert torch.equal(got[k], local_slice(v, specs[k], mesh, r)), \
                (world, r, k)


def test_the_worlds_split_what_they_claim():
    """The plan's flags and the group layouts the worlds exercise."""
    flags = {}
    for name, (arch, over, shape, _, _) in WORLDS.items():
        cfg = get_config(arch).smoke().replace(**dict(over))
        flags[name] = tp._splits(cfg, Ruler(cfg, stand_in(shape)))
    assert flags == {"ssm": (True, False), "ssm_fsdp": (False, False),
                     "moe": (False, True), "maverick": (False, True),
                     "hybrid": (True, True)}
    jamba = get_config(JAMBA).smoke()
    assert (jamba.ssm_heads, jamba.ssm_groups) == (8, 8)
    specs = param_specs(jamba, model_shapes(jamba), stand_in((1, 1, 2)))
    assert specs["blocks/s1_ffn/w_down"] == (None, "model", None, None)
    assert specs["blocks/s0_mix/w_b"] == (None, None, "model")
    assert specs["blocks/s1_ffn/router"] == (None, None, None)


@pytest.mark.parametrize("heads,groups,m,want", [
    (80, 1, 2, [(0, 1), (0, 1)]),       # mamba2-2.7b: the one group
    (256, 8, 2, [(0, 4), (4, 8)]),      # Jamba: 4 groups a rank
    (256, 8, 16, [(r // 2, r // 2 + 1) for r in range(16)]),
])
def test_a_rank_reads_the_groups_of_its_heads(heads, groups, m, want):
    """Whole groups, or the one group several ranks' heads share: always
    the group of each of the rank's heads."""
    cfg = SimpleNamespace(ssm_heads=heads, ssm_groups=groups)
    hpg, n = heads // groups, heads // m
    for r in range(m):
        plan = SimpleNamespace(model=SimpleNamespace(rank=r))
        sel = ssm._rank_groups(plan, cfg, n)
        assert (sel.start, sel.stop) == want[r]
        per = n // (sel.stop - sel.start)
        assert [sel.start + j // per for j in range(n)] == \
            [h // hpg for h in range(r * n, (r + 1) * n)]


def test_check_family_refuses_a_head_cut_in_two():
    """mamba2's smoke d_inner 256 splits 16 ways, its 8 heads do not; 4
    ways split both, and B/C's 32 columns with them; B/C's columns kept
    whole, or a rank's heads straddling groups, are refused too."""
    cfg = get_config(MAMBA).smoke()
    with pytest.raises(NotImplementedError, match="cut in two"):
        tp.check_family(cfg, stand_in((1, 1, 16)))
    tp.check_family(cfg, stand_in((1, 1, 4)))
    with pytest.raises(NotImplementedError, match="both or neither"):
        tp.check_family(cfg.replace(ssm_state=33), stand_in((1, 1, 4)))
    with pytest.raises(NotImplementedError, match="straddle"):
        # 6 heads in 3 groups of 2: a rank's 3 heads span two groups
        tp.check_family(cfg.replace(d_model=96, ssm_groups=3),
                        stand_in((1, 1, 2)))
    tp.check_family(cfg.replace(ssm_groups=2), stand_in((1, 1, 8)))


def test_moe_refuses_a_data_share_of_partial_groups():
    """Under "data" a rank's tokens must make whole routing groups."""
    cfg = get_config(SCOUT).smoke()
    plan = SimpleNamespace(data=SimpleNamespace(size=2), ep=False)
    x = torch.zeros((1, 8, cfg.d_model))
    with active_plan(plan), pytest.raises(ValueError, match="whole MoE"):
        moe.moe_ffn({}, cfg, x)


# ----------------------------------------------------- vs one process ----
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
        np.testing.assert_allclose(
            [h["loss"] for h in rank[case]["history"]],
            [h["loss"] for h in one["history"]], rtol=1e-6, atol=tol)


@pytest.mark.parametrize("world,case", [
    (n, c) for n, c in _cases(with_load=False) if c in REF_CASES])
def test_rounds_match_reference(worlds, world, case):
    w = worlds[world]
    ref, losses = w["refs"][case]
    tol = ROUND_TOL[ROUNDS[case]]
    got = _whole(w, case)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k].numpy(), v, atol=tol, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(
        [h["loss"] for h in w["ranks"][0][case]["history"]], losses,
        rtol=1e-6, atol=tol)


@pytest.mark.parametrize("world,case", _cases(with_load=False))
def test_every_leaf_moves_past_the_bound(worlds, world, case):
    moved = worlds[world]["one"][case]["moved"]
    least = min(moved, key=moved.get)
    assert moved[least] > ROUND_TOL[ROUNDS[case]], (least, moved[least])


@pytest.mark.parametrize("world", list(WORLDS))
def test_a_fault_planted_in_one_rank_fails_the_check(worlds, world):
    """Rank `FAULT_RANK`'s slice of the family's fault leaf (mamba2: the
    mixer's ``w_out``; scout: the first expert stack's ``w_down``) 1% off
    before a FedAvg round: its slices leave the one-process bound."""
    w = worlds[world]
    leaf = pod_check.fault_leaf(w["cfg"])
    assert leaf in w["one"]["fedavg"]["params"]
    specs, mesh = _specs(w), stand_in(w["spec"].mesh_shape)
    tol = ROUND_TOL[1]
    worst = []
    for r, rec in enumerate(w["fault"]):
        got = rec["fedavg"]["params"]
        ref = {k: local_slice(v, specs[k], mesh, r)
               for k, v in w["one"]["fedavg"]["params"].items()}
        worst.append({k: float((got[k] - ref[k]).abs().max()) for k in got})
    assert max(max(d.values()) for d in worst) > 100 * tol, worst
    assert worst[pod_check.FAULT_RANK][leaf] > tol


def test_one_moe_ffn_is_held_to_one_process(worlds):
    """Scout's smoke MoE FFN on (1, 1, 2), 2 experts a rank: output, aux
    and every gradient equal to one process (top-1: one rank computes each
    token's expert, the others add zeros), the dropped choices equal, the
    bytes the forward's and backward's all-reduces; rank 1's expert
    ``w_down`` slice 1% off fails."""
    params, x, g = pod_check.moe_ffn_inputs(MOE_FFN, "cpu")
    one = pod_check.moe_ffn_pass(MOE_FFN, params, x, g)
    cfg = MOE_FFN.config()
    act = MOE_FFN.tokens * cfg.d_model * 4
    rel = []
    for r, (held, bad) in enumerate(worlds["moe"]["moe_ffn"]):
        assert held["experts"] == cfg.n_experts // 2 and held["ep"]
        assert held["dropped"] == held["one_process_dropped"] \
            == one["dropped"] == bad["dropped"]
        for k, d in held["max_abs"].items():
            assert d <= 1e-6 * held["max_ref"][k], (r, k, d)
        assert axis_bytes(held["log"]) == {"model": {
            "all-reduce": 2 * act + MOE_FFN.tokens * cfg.top_k * 4}}
        rel.append(max(d / bad["max_ref"][k]
                       for k, d in bad["max_abs"].items()))
    assert one["dropped"] > 0
    assert max(rel) > 1e-3, rel


# -------------------------------------------------------- collectives ----
def _lanes_run(case) -> int:
    return 1 if CASES[case][5] else K      # sparse: the even client


@pytest.mark.parametrize("world,case", _cases(with_load=False))
def test_collective_bytes_per_axis_are_the_closed_form(worlds, world, case):
    w = worlds[world]
    kind, rounds, _, hp_kw, _, _ = CASES[case]
    want = tp.merge((tp.round_bytes(
        w["cfg"], w["spec"].mesh_shape, clients=K, batch=B, seq=S,
        mode=kind, lanes_run=_lanes_run(case), topk=hp_kw.get("topk")),
        rounds))
    for r, rank in enumerate(w["ranks"]):
        assert axis_bytes(rank[case]["log"]) == want, (world, r)
    assert w["one"][case]["log"] == []


# ------------------------------------------------------------- decode ----
@pytest.mark.parametrize("world", list(WORLDS))
def test_decode_under_plan_matches_one_process(worlds, world):
    w = worlds[world]
    spec = _decode_spec(world)
    want = tp.decode_bytes(spec.config(), spec.mesh_shape, batch=spec.batch,
                           window=spec.seq_len)
    for r, recs in enumerate(w["decode"]):
        got = dc.compare(recs[0], w["decode_one"], DECODE_RTOL)
        assert got["ok"], (world, r, got)
        assert recs[0]["step_bytes"] == want, (world, r)
    if world in DECODE_FAULTS:
        checks = [dc.compare(recs[1], w["decode_one"], DECODE_RTOL)
                  for recs in w["decode"]]
        assert max(c["max_abs"] / c["bound"] for c in checks) > 1, checks


# ------------------------------------------------------------- dry run ----
@pytest.mark.parametrize("arch", [MAMBA, SCOUT, MAVERICK, JAMBA])
def test_dryrun_decode_record_is_ok(arch, tmp_path, monkeypatch):
    """The dry run's decode step at full width on the fake 16 x 16 world
    (each rank its slices: mamba2's 5 of 80 heads, scout's one of 16
    experts)."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    try:
        rec = dryrun.run_one(arch, "decode_32k", multi_pod=False,
                             device="cpu", verbose=False)
    finally:
        dryrun.close_world()
    assert rec["status"] == "ok", rec.get("error")
    assert rec["coll_by_axis"]["model"]["all-reduce"] > 0
