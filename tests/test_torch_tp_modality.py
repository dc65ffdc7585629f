"""Tensor parallelism and FSDP of the encoder-decoder (whisper-small) and
the VLM (phi-3-vision-4.2b) (`repro_torch.launch.tp`, `models/encdec.py`,
`models/attention.py`'s cross-attention, `models/transformer.py`'s
projector) over ``torch.distributed`` ranks (gloo on the CPU), against the
same rounds in one process and against the reference's
`repro.core.llm_dsfl` rounds.

Worlds, each spawned once (all at once) with its rounds, a fault run and
a decode run in one spawn (`launch.pod_check`'s cases; K = 2, batch 2,
seq 32, float32, the plain routes, the smoke configs, from the port's
keyed init, which the reference's rounds start from too; the frames and
patches `launch.train.extra_inputs` draws, shared by the clients and the
open set):

  * "audio": whisper-small's smoke config (4 heads of 32, 2 + 2 layers,
    32 frames, vocabulary 512) on (1, 1, 2): 2 heads a rank in the
    encoder's attention, the decoder's self- and cross-attention, the
    MLPs' columns and the vocabulary split;
  * "audio_fsdp": the same on (1, 2, 1): every d_model dimension over
    "data", each data rank encoding and decoding one of the two
    sequences;
  * "audio_both": the same on (1, 2, 2);
  * "vlm": phi-3-vision-4.2b's (16 patches) on (1, 1, 2): the projector's
    columns over "model", gathered whole;
  * "vlm_fsdp": the same on (1, 2, 1).

The learning rates are each family's least of 1e-4, 3e-4, 1e-3, ... at
which every leaf of the one-process rounds moves past the bound (whisper's
``dec/n2/scale`` moves least: 1.3e-4 after 2 ERA rounds at 1e-3, 4.2e-5 at
3e-4; phi-3-vision's ``wk``: 1.8e-4 at 3e-4, 6.1e-5 at 1e-4).  Held: each
rank's leaves are exactly `local_slice` of the one-process leaves before
any round; after each case within 1e-5 after one round and 1e-4 after two
(loss rtol 1e-6) of the one-process port, and of the reference (ERA, top-k
8 and FedAvg; the sparse round, participation 0.5, of the one-process port
only); every leaf of the one-process round moved past that bound; a 1%
fault planted in one rank's slice of `pod_check.fault_leaf` (whisper's
``dec/mlp/w_down``, phi-3-vision's ``patch_proj/w``) before a FedAvg round
caught; each rank's log per axis equal to `tp.round_bytes`; a greedy
decode under the plan (whisper on (1, 1, 2) at batch 2, its heads split,
and on (1, 2, 1) at batch 1, the cross cache's 32 encoder positions split
over "data"; phi-3-vision on (1, 1, 2)) equal to one process in tokens and
within 1e-5 of its largest logit, its bytes `tp.decode_bytes`, a fault in
one rank's cross values caught; the dry run's ``decode_32k`` record ``ok``
for both architectures."""
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
from repro.core import llm_dsfl as J
from repro_torch.configs import get_config
from repro_torch.convert import to_numpy_tree
from repro_torch.core.engine import open_batch
from repro_torch.data.pipeline import build_lm_task
from repro_torch.launch import decode_check as dc
from repro_torch.launch import dist, dryrun, pod_check, tp
from repro_torch.launch.pod_check import CASES, DrillSpec, run_cases
from repro_torch.launch.roofline import axis_bytes
from repro_torch.launch.sharding import (Ruler, local_cache_shapes,
                                         local_slice, model_shapes,
                                         param_specs)
from repro_torch.launch.train import extra_inputs

from test_torch_convert import flat_ref
from test_torch_convert import one_intra_op_thread  # noqa: F401

K, B, S = 2, 2, 32
ROUND_TOL = {1: 1e-5, 2: 1e-4}
DECODE_RTOL = 1e-5
WHISPER, VLM = "whisper-small", "phi-3-vision-4.2b"
LR = {WHISPER: 1e-3, VLM: 3e-4}
# name -> (arch, mesh, cases)
WORLDS = {
    "audio": (WHISPER, (1, 1, 2), ("load", "era", "topk", "sparse",
                                   "fedavg")),
    "audio_fsdp": (WHISPER, (1, 2, 1), ("load", "era", "fedavg")),
    "audio_both": (WHISPER, (1, 2, 2), ("load", "era", "fedavg")),
    "vlm": (VLM, (1, 1, 2), ("load", "era", "topk", "sparse", "fedavg")),
    "vlm_fsdp": (VLM, (1, 2, 1), ("load", "era", "fedavg")),
}
# name -> (decode batch, faults): whisper at batch 1 on (1, 2, 1) splits
# its cross cache's encoder positions (and its self rings) over "data"
DECODE = {"audio": (2, ("cross_v",)), "audio_fsdp": (1, ("cross_v",)),
          "vlm": (2, ())}
ROUNDS = {c: v[1] for c, v in CASES.items()}
# the cases held to the reference too (sparse: to one process)
REF_CASES = ("era", "topk", "fedavg")


def stand_in(shape):
    return SimpleNamespace(axis_names=("pod", "data", "model"),
                           devices=np.empty(shape))


def _spec(name) -> DrillSpec:
    arch, shape, cases = WORLDS[name]
    return DrillSpec(arch=arch, mesh_shape=shape, clients=K, batch=B, seq=S,
                     lr=LR[arch], cases=cases)


def _decode_spec(name) -> dc.DecodeSpec:
    arch, shape, _ = WORLDS[name]
    return dc.DecodeSpec(arch=arch, mesh_shape=shape, batch=DECODE[name][0])


def _programs(name) -> tuple:
    """The world's rank programs: its rounds, the fault run (rank
    `FAULT_RANK`'s slice 1% off before a FedAvg round, held to the
    one-process leaves) and, where it decodes, its greedy decode and
    decode faults."""
    spec = _spec(name)
    fault = dataclasses.replace(spec, cases=("fedavg",), fault=True)
    programs = ((pod_check.rank_main_many, ((spec, fault), (None, None))),)
    if name in DECODE:
        dspec = _decode_spec(name)
        dspecs = (dspec,) + tuple(dataclasses.replace(dspec, fault=f)
                                  for f in DECODE[name][1])
        programs += ((dc.rank_main, (dspecs, "cpu")),)
    return spec, programs


@pytest.fixture(scope="module", autouse=True)
def one_thread_ranks():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        mp.setenv("MKL_NUM_THREADS", "1")
        yield


# ------------------------------------------------------------ reference ----
def _ref_case(arch, tree, case):
    """The reference's rounds of ``case`` from the client-stacked leaves
    ``tree`` (numpy, the reference's nesting) on the task `run_cases`
    builds (tokens, then the frames or patches); run in a process of its
    own (`worlds`), so the compiles run side by side."""
    jst = jax.tree.map(jnp.asarray, tree)
    jcfg = jget_config(arch).smoke()
    lr = LR[arch]
    kind, rounds, _, hp_kw, _, _ = CASES[case]
    if kind == "dsfl":
        hp = J.LLMDsflHP(lr=lr, topk=hp_kw.get("topk"))
        step = jax.jit(lambda p, a, b: J.dsfl_round_step(jcfg, p, a, b, hp))
    else:
        step = jax.jit(lambda p, a, b: J.fedavg_round_step(jcfg, p, a, lr))
    cfg = get_config(arch).smoke()
    task = build_lm_task(0, K, B, S, cfg.vocab, device="cpu",
                         extras_fn=lambda b, g: extra_inputs(cfg, b, g))
    as_j = lambda v: jnp.asarray(v.numpy(), jnp.int32 if v.dtype in (
        torch.int32, torch.int64) else jnp.float32)
    pb = {k: as_j(v) for k, v in task.x_clients.items()}
    losses = []
    for r in range(rounds):
        o = open_batch(0, r, B, B, "cpu")
        ob = {k: as_j(v.index_select(0, o)) for k, v in task.open_x.items()}
        jst, loss = step(jst, pb, ob)
        losses.append(float(loss))
    return flat_ref(jst), losses


# --------------------------------------------------------------- worlds ----
@pytest.fixture(scope="module")
def worlds():
    """Per world: the ranks' records (spawned at once), the one-process
    cases and decode, and the reference's rounds (each (arch, case) once,
    compiled in processes of their own meanwhile)."""
    out, refs = {}, {}
    spawn = multiprocessing.get_context("spawn")
    with ThreadPoolExecutor(len(WORLDS)) as threads, \
            ProcessPoolExecutor(3, mp_context=spawn) as procs:
        spawns = {}
        for name in WORLDS:
            spec, programs = _programs(name)
            spawns[name] = threads.submit(
                dist.spawn, dist.rank_programs, int(np.prod(spec.mesh_shape)),
                programs)
        ones = {}
        for name in WORLDS:
            spec, _ = _programs(name)
            arch = spec.arch
            if arch not in ones:
                # every world of an arch runs the one-process cases of the
                # arch's first world, which has them all
                one = run_cases(dataclasses.replace(
                    spec, mesh_shape=None, keep_values=("fedavg",)))
                one["fedavg"]["params"] = one["fedavg"].pop("values")
                ones[arch] = one
                tree = to_numpy_tree(one["load"]["params"])
                for c in REF_CASES:
                    refs[arch, c] = procs.submit(_ref_case, arch, tree, c)
            w = out[name] = dict(spec=spec, cfg=spec.config(), one=ones[arch])
            if name in DECODE:
                dspec = _decode_spec(name)
                w["decode_one"] = dc.greedy(dspec, dc.init_params(
                    dspec, "cpu"), "cpu")
        for name, w in out.items():
            w["refs"] = {c: f.result() for (a, c), f in refs.items()
                         if a == w["spec"].arch}
            recs = spawns[name].result()
            w["ranks"] = [r[0][0] for r in recs]
            w["fault"] = [r[0][1] for r in recs]
            if name in DECODE:
                w["decode"] = [r[1] for r in recs]
    return out


def _specs(w) -> dict:
    return param_specs(w["cfg"], model_shapes(w["cfg"], lead=(K,)),
                       stand_in(w["spec"].mesh_shape), client_axis="pod")


def _cases(with_load=True):
    return [(n, c) for n, v in WORLDS.items() for c in v[2]
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
    """The plan's flags the worlds exercise, and the leaves of the
    encoder, the decoder's cross-attention, ``pos_dec`` and the projector
    the rules split."""
    for name, (arch, shape, _) in WORLDS.items():
        cfg = get_config(arch).smoke()
        r = Ruler(cfg, stand_in(shape))
        split = shape[2] > 1
        assert (r.attn_tp, r.M(cfg.d_ff) is not None,
                r.M(cfg.eff_vocab) is not None) == (split,) * 3, name
        assert tp._proj_tp(cfg, r) == (split and arch == VLM), name
    audio = get_config(WHISPER).smoke()
    specs = param_specs(audio, model_shapes(audio), stand_in((1, 2, 2)))
    assert specs["enc/attn/wq"] == (None, "data", "model")
    assert specs["dec/cross/wo"] == (None, "model", "data")
    assert specs["dec/mlp/w_down"] == (None, "model", "data")
    assert specs["pos_dec"] == (None, "data")
    vlm = get_config(VLM).smoke()
    specs = param_specs(vlm, model_shapes(vlm), stand_in((1, 2, 2)))
    assert specs["patch_proj/w"] == ("data", "model")


def test_every_stack_is_gathered_block_by_block():
    """FSDP's "data" dims of the ``enc/`` and ``dec/`` leaves are within
    one block, and every stack counts its own depth in the closed
    forms."""
    cfg = get_config(WHISPER).smoke().replace(enc_layers=3)
    specs = param_specs(cfg, model_shapes(cfg), stand_in((1, 2, 1)))
    dims = tp._data_dims(specs)
    assert dims["enc/attn/wq"] == 0 and dims["dec/cross/wk"] == 0
    assert dims["pos_dec"] == 1 and dims["enc/n1/scale"] is None
    times = {k: t for k, _, t, _, _ in tp._leaves(cfg, (1, 2, 1))}
    assert times["enc/attn/wq"] == 3 and times["dec/self/wq"] == 2
    assert times["pos_dec"] == 1


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


@pytest.mark.parametrize("arch", [WHISPER, VLM])
@pytest.mark.parametrize("case", ["era", "topk", "sparse", "fedavg"])
def test_every_leaf_moves_past_the_bound(worlds, arch, case):
    w = next(w for w in worlds.values() if w["spec"].arch == arch)
    moved = w["one"][case]["moved"]
    least = min(moved, key=moved.get)
    assert moved[least] > ROUND_TOL[ROUNDS[case]], (least, moved[least])


@pytest.mark.parametrize("world", list(WORLDS))
def test_a_fault_planted_in_one_rank_fails_the_check(worlds, world):
    """Rank `FAULT_RANK`'s slice of the family's fault leaf (whisper: the
    first decoder MLP's ``w_down``; phi-3-vision: the projector) 1% off
    before a FedAvg round: its slices leave the one-process bound."""
    w = worlds[world]
    leaf = pod_check.fault_leaf(w["cfg"])
    assert leaf == {WHISPER: "dec/mlp/w_down",
                    VLM: "patch_proj/w"}[w["spec"].arch]
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


def test_the_closed_form_counts_the_new_collectives():
    """Whisper's grad pass on (1, 1, 2) against its parts: per encoder
    block two all-reduces of the frames' activations forward, again in
    the recompute, and two for the copies' gradients; per decoder block
    three (self, cross, MLP) of the tokens'; the encoder states' one
    gradient all-reduce; the embedding's and the unembedding's, the
    logits' gather.  phi-3-vision's pass adds the projector's gather of
    the patches' columns to a backbone over patches and tokens."""
    cfg = get_config(WHISPER).smoke()
    rows, seqs, e = B * S, B, 4
    frames = seqs * cfg.n_audio_frames * cfg.d_model * e
    act = rows * cfg.d_model * e
    want = {"all-reduce": cfg.enc_layers * 6 * frames
            + cfg.n_layers * 9 * act + frames + 2 * act,
            "all-gather": rows * cfg.eff_vocab * e}
    assert tp.pass_bytes(cfg, (1, 1, 2), rows, True, seqs) == {"model": want}
    vlm = get_config(VLM).smoke()
    patches = seqs * vlm.n_patches * vlm.d_model * e
    fwd = tp.pass_bytes(vlm, (1, 1, 2), rows, False, seqs)["model"]
    assert fwd == {"all-reduce": vlm.n_blocks * 2 * (act + patches) + act,
                   "all-gather": rows * vlm.eff_vocab * e + patches}
    with pytest.raises(ValueError, match="sequences"):
        tp.pass_bytes(vlm, (1, 1, 2), rows, False)


# ------------------------------------------------------------- decode ----
@pytest.mark.parametrize("world", list(DECODE))
def test_decode_under_plan_matches_one_process(worlds, world):
    w = worlds[world]
    spec = _decode_spec(world)
    want = tp.decode_bytes(spec.config(), spec.mesh_shape, batch=spec.batch,
                           window=spec.seq_len)
    for r, recs in enumerate(w["decode"]):
        got = dc.compare(recs[0], w["decode_one"], DECODE_RTOL)
        assert got["ok"], (world, r, got)
        assert recs[0]["step_bytes"] == want, (world, r)
    if DECODE[world][1]:
        checks = [dc.compare(recs[1], w["decode_one"], DECODE_RTOL)
                  for recs in w["decode"]]
        assert max(c["max_abs"] / c["bound"] for c in checks) > 1, checks


def test_the_cross_cache_splits_where_the_world_says():
    """Whisper's cross cache on (1, 2, 1): at batch 1 its encoder
    positions over "data" (merged each step over that axis), at batch 2
    its rows; on (1, 1, 2) its heads over "model"."""
    cfg = get_config(WHISPER).smoke()
    cache = {"cross_k": (cfg.n_layers, 1, cfg.n_audio_frames,
                         cfg.eff_kv_heads, cfg.hd)}
    shapes = lambda shape, b: local_cache_shapes(
        cfg, {"cross_k": (cache["cross_k"][0], b) + cache["cross_k"][2:]},
        stand_in(shape), b)["cross_k"]
    assert shapes((1, 2, 1), 1)[2] == cfg.n_audio_frames // 2
    assert shapes((1, 2, 1), 2)[1:3] == (1, cfg.n_audio_frames)
    assert shapes((1, 1, 2), 2)[3] == cfg.eff_kv_heads // 2
    merge = tp.decode_bytes(cfg, (1, 2, 1), batch=1, window=16)["data"]
    heads = cfg.eff_heads * 4 * (cfg.hd + 2)
    # the self rings' 16 slots and the 32 positions, each split over data
    assert merge["all-reduce"] == 2 * cfg.n_layers * heads


# ------------------------------------------------------------- dry run ----
@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_dryrun_decode_record_is_ok(arch, tmp_path, monkeypatch):
    """The dry run's decode step at full width on the fake 16 x 16 world
    (each rank its slices: whisper's MLP columns and its self rings' slots
    over "model", phi-3-vision's heads)."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    try:
        rec = dryrun.run_one(arch, "decode_32k", multi_pod=False,
                             device="cpu", verbose=False)
    finally:
        dryrun.close_world()
    assert rec["status"] == "ok", rec.get("error")
    assert rec["coll_by_axis"]["model"]["all-reduce"] > 0
    assert rec["coll_by_axis"]["data"]["all-gather"] > 0
