"""The dry run over fake ranks (`repro_torch.launch.dryrun`), its
stand-ins (`launch.specs`), its counters (`launch.costs`) and
`Roofline.build`, on the CPU.

Held: every architecture's stand-ins for every input shape equal the
reference's ``jax.ShapeDtypeStruct`` leaves (`repro.launch.specs`) in
shape and dtype; a fake trace's FLOPs, bytes, live peak and op calls
equal the same step's on real CPU tensors exactly (qwen1.5-4b's smoke
client step with K3/K4, mamba2-2.7b's smoke prediction with K5, a decode
step); the 1- and 2-block counts extrapolate exactly to a deeper trace's
and the 2- and 3-block records to its whole record, live peak included,
at full width on the fake 16 x 16 world; phi3-medium-14b's ERA round at
full width logs, on fake meshes, the bytes by axis of `tp.round_bytes` and of
PERF.md's card runs; the records' statuses; `Roofline.build`'s terms."""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.configs.shapes import InputShape
from repro_torch.core.llm_dsfl import (LLMDsflHP, dsfl_client_step,
                                       predict_open_probs)
from repro_torch.launch import costs, dryrun, specs, tp
from repro_torch.launch.roofline import (IB_BYTES_PER_S, NVLINK_BYTES_PER_S,
                                         Roofline, link_rate)
from repro_torch.models.api import model_decode_step, model_init
from repro_torch.models.transformer import init_cache

from test_torch_convert import one_intra_op_thread  # noqa: F401

DT = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32,
      jnp.int32: torch.int32}


@pytest.fixture(scope="module", autouse=True)
def _world_closed():
    yield
    dryrun.close_world()


def _jflat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = (tuple(leaf.shape),
                                        DT[jnp.dtype(leaf.dtype).type])
    return out


def _tflat(tree) -> dict:
    if isinstance(tree, torch.Tensor):
        return {"": (tuple(tree.shape), tree.dtype)}
    if isinstance(tree, tuple):
        return {f"{i}/{k}".rstrip("/"): v for i, t in enumerate(tree)
                for k, v in _tflat(t).items()}
    return {k: (tuple(v.shape), v.dtype) for k, v in tree.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_stand_ins_match_the_reference(arch, monkeypatch):
    """params, private, open, teacher (dense and top-k), cache, token and
    pos, with 1 and 2 clients, for every shape: shape and dtype equal (one
    model's fake init a client count, and the reference's one
    ``eval_shape`` of it, reused across the shapes)."""
    made, init, jmade, jinit = {}, specs.params_struct, {}, \
        jspecs.params_struct

    def params_struct(cfg, **kw):
        key = (cfg, kw.get("n_clients", 1))
        if key not in made:
            made[key] = init(cfg, **kw)
        return made[key]

    def jparams_struct(cfg):
        if cfg not in jmade:
            jmade[cfg] = jinit(cfg)
        return jmade[cfg]
    monkeypatch.setattr(specs, "params_struct", params_struct)
    monkeypatch.setattr(jspecs, "params_struct", jparams_struct)
    for name, shape in SHAPES.items():
        for n_clients, topk in ((1, None), (1, 8), (2, None)):
            if shape.kind != "train" and (n_clients, topk) != (1, None):
                continue
            ref = jspecs.input_specs(jget_config(arch), JSHAPES[name],
                                     n_clients=n_clients, topk=topk)
            got = specs.input_specs(get_config(arch), shape,
                                    n_clients=n_clients, topk=topk,
                                    device="cpu")
            assert got["cfg"].sliding_window == ref["cfg"].sliding_window
            keys = set(ref) - {"cfg"}
            assert keys == set(got) - {"cfg", "mode"}, (name, keys)
            for k in keys:
                assert _tflat(got[k]) == _jflat(ref[k]), (arch, name, k)


def _smoke_inputs(cfg, B, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = model_init(cfg, torch.Generator().manual_seed(seed), "cpu")
    tok = lambda: {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g,
                                           dtype=torch.int32)}
    teacher = torch.softmax(torch.randn(B, S, cfg.eff_vocab, generator=g),
                            -1).to(torch.bfloat16)
    return params, tok(), tok(), teacher


def _fake_and_real(cfg, step, fake_args, real_args):
    mode = next(iter(fake_args[0].values())).fake_mode
    with mode, costs.count(*fake_args) as fake:
        step(*fake_args)
    with costs.count(*real_args) as real:
        step(*real_args)
    return fake.to_dict(), real.to_dict()


def test_fake_trace_equals_the_real_run():
    """FLOPs, bytes, live peak, arguments and op calls of a fake trace
    equal the real CPU run's, exactly."""
    hp = LLMDsflHP(use_kernel=True, lr=1e-3)
    cfg = get_config("qwen1.5-4b").smoke()
    sp = specs.input_specs(cfg, InputShape("t", 16, 2, "train"),
                           device="cpu")
    fake = (sp["params"], sp["private"], sp["open"], sp["teacher"])
    step = lambda *a: dsfl_client_step(cfg, *a, hp)
    f, r = _fake_and_real(cfg, step, fake, _smoke_inputs(cfg, 2, 16))
    assert f == r and f["ops"] == {"distill_loss_fwd": 1,
                                   "distill_loss_bwd": 1}
    assert f["flops"] > 0 and f["peak_bytes"] > f["arg_bytes"]

    cfg = get_config("mamba2-2.7b").smoke()
    sp = specs.input_specs(cfg, InputShape("p", 32, 2, "prefill"),
                           device="cpu")
    real = _smoke_inputs(cfg, 2, 32)
    step = lambda p, o: predict_open_probs(cfg, p, o, use_kernel=True)
    f, r = _fake_and_real(cfg, step, (sp["params"], sp["open"]),
                          (real[0], real[2]))
    assert f == r and f["ops"] == {"ssd_chunk": cfg.n_blocks}

    cfg = get_config("phi3-medium-14b").smoke()
    sp = specs.input_specs(cfg, InputShape("d", 16, 3, "decode"),
                           device="cpu")
    real = (model_init(cfg, torch.Generator().manual_seed(1), "cpu"),
            init_cache(cfg, 3, 16, "cpu"),
            torch.tensor([1, 2, 3], dtype=torch.int32),
            torch.tensor(5, dtype=torch.int32))

    def decode(p, c, t, pos):
        with torch.no_grad():
            return model_decode_step(cfg, p, c, t, pos)
    f, r = _fake_and_real(cfg, decode, (sp["params"], sp["cache"],
                                        sp["token"], sp["pos"]), real)
    assert f == r


# (mesh, dtype, layers) -> the ERA round's bytes a rank by axis that
# PERF.md records from the card (chip_smoke.py phase "tp",
# tools/pod_cards.py (c)), a round
PERF_ERA = {((1, 1, 2), "float32", 4): {
    "": {"all-gather": 411_041_800},
    "model": {"all-reduce": 2_558_525_440, "all-gather": 2_466_250_752}},
    ((2, 1, 2), "bfloat16", 40): {
    "pod": {"all-gather": 411_041_800},
    "model": {"all-reduce": 5_924_454_400, "all-gather": 616_562_688}}}
ERA_SHAPE = InputShape("era", 128, 16, "train")


@functools.cache
def _era_trace(mesh_shape, dtype, blocks):
    """phi3-medium-14b's ERA round (K = 2, batch 8, seq 128, the kernels
    on) at full width and ``blocks`` blocks, traced once on the fake
    ``mesh_shape`` world (its collectives and op calls: no live peak)."""
    cfg = dryrun.reduced(get_config("phi3-medium-14b").replace(dtype=dtype),
                         blocks)
    mesh = dryrun.fake_world(device="cpu", shape=mesh_shape)
    return dryrun.trace(cfg, ERA_SHAPE, mesh, multi_pod=True, device="cpu",
                        sites=False)[0]


def test_block_counts_extrapolate_exactly():
    """phi3-medium-14b's prediction pass at full width on the fake 16 x 16
    world: the 1- and 2-block counts extrapolate to a 4-block trace's
    exactly (FLOPs, bytes, arguments, op calls and collectives by axis:
    the reference's premise), and the 2- and 3-block records, the dry
    run's depths, to its whole record (the live peak too, whose op moves
    with the depth).  A training step's: the ERA round's collectives
    below, and chip_smoke.py's trainer windows against the card."""
    mesh = dryrun.fake_world(False, "cpu")
    cfg = get_config("phi3-medium-14b")
    shape = InputShape("p", 64, 32, "prefill")
    r = {n: dryrun.trace(dryrun.reduced(cfg, n), shape, mesh,
                         multi_pod=False, device="cpu")[0]
         for n in (1, 2, 3, 4)}
    # at one block the first block is also the last: the peak is the 2-
    # and 3-block extrapolation's
    drop = lambda rec: {k: v for k, v in rec.to_dict().items()
                        if k != "peak_bytes"}
    assert drop(dryrun.extrapolate(r[1], r[2], 1, 2, 4)) == drop(r[4])
    assert dryrun.extrapolate(r[2], r[3], 2, 3, 4).to_dict() == \
        r[4].to_dict()
    assert r[4].coll


def test_era_round_collectives_at_full_width():
    """phi3-medium-14b's ERA round traced on fake (1, 1, 2) and (2, 1, 2)
    meshes: bytes a rank by axis equal `tp.round_bytes` and the card's
    (PERF.md), the counts extrapolated from 1 and 2 blocks (exact:
    `test_block_counts_extrapolate_exactly`)."""
    for (mesh_shape, dtype, layers), want in PERF_ERA.items():
        cfg = get_config("phi3-medium-14b").replace(dtype=dtype,
                                                    n_layers=layers)
        rec = dryrun.extrapolate(_era_trace(mesh_shape, dtype, 1),
                                 _era_trace(mesh_shape, dtype, 2), 1, 2,
                                 layers)
        assert rec.coll == want, (mesh_shape, rec.coll)
        lanes = 2 // mesh_shape[0]
        assert rec.ops == {"era_sharpen": 1, "distill_loss_fwd": lanes,
                           "distill_loss_bwd": lanes}
        closed = lambda n: tp.round_bytes(
            cfg.replace(n_layers=n), mesh_shape, clients=2, batch=8,
            seq=128, mode="dsfl", lanes_run=2 // mesh_shape[0])
        assert rec.coll == closed(layers)


def test_records_and_roofline(tmp_path, monkeypatch):
    """Statuses: the dense decode ``ok`` with `Roofline.build`'s terms (at
    6 of its 40 layers, the record extrapolated from 2 and 3 blocks equal
    to the one traced whole), the VLM family's decode ``ok`` (no record is
    ``unsupported`` any more), whisper-small x long_500k ``skipped``."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    rec = dryrun.run_one("phi3-medium-14b", "decode_32k", multi_pod=False,
                         device="cpu", verbose=False)
    assert rec["status"] == "ok"
    six = lambda cfg: cfg.replace(n_layers=6)
    cut, full = (dryrun.run_one("phi3-medium-14b", "decode_32k",
                                multi_pod=False, device="cpu", verbose=False,
                                tag=tag, cfg_mod=six, full_depth=whole)
                 for tag, whole in (("_6", False), ("_6_full", True)))
    drop = ("trace_s", "cost_s", "depth")
    assert cut["status"] == "ok" and full["status"] == "ok"
    assert {k: v for k, v in cut.items() if k not in drop} == \
        {k: v for k, v in full.items() if k not in drop}
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["step"] == "serve_step" and rec["bottleneck"] == "collective"
    # FSDP's weight gathers cross nodes: "data" groups span 16 nodes
    assert rec["t_collective"] == pytest.approx(
        rec["coll_by_axis"]["data"]["all-gather"] / IB_BYTES_PER_S
        + sum(rec["coll_by_axis"]["model"].values()) / IB_BYTES_PER_S)
    assert rec["memory"]["peak_size"] == rec["peak_mem_bytes"]
    vlm = dryrun.run_one("phi-3-vision-4.2b", "decode_32k", multi_pod=False,
                         device="cpu", verbose=False)
    assert vlm["status"] == "ok", vlm.get("error")
    sk = dryrun.run_one("whisper-small", "long_500k", multi_pod=True,
                        device="cpu", verbose=False)
    assert sk["status"] == "skipped"


def test_roofline_build_terms_and_links():
    """Each axis's bytes at its link: NVLink inside an 8-rank node,
    InfiniBand across nodes; useful ratio over every rank's FLOPs."""
    assert link_rate({"data": 2, "model": 4}, "model") == NVLINK_BYTES_PER_S
    assert link_rate({"data": 2, "model": 4}, "data") == NVLINK_BYTES_PER_S
    assert link_rate({"data": 16, "model": 16}, "model") == IB_BYTES_PER_S
    assert link_rate({"pod": 2, "data": 4, "model": 2}, "pod") == \
        IB_BYTES_PER_S
    c = costs.Costs(flops=989e12, bytes=3.35e12, peak_bytes=7, arg_bytes=5,
                    coll={"model": {"all-reduce": 450e9}, "": {"x": 1}})
    rl = Roofline.build(arch="a", shape="s", mesh_name="1x8", step="st",
                        costs=c, mesh_shape={"data": 1, "model": 8},
                        model_flops=989e12 * 4)
    assert (rl.t_compute, rl.t_memory, rl.t_collective) == pytest.approx(
        (1.0, 1.0, 1.0))
    assert rl.useful_ratio == pytest.approx(0.5) and rl.n_devices == 8
    assert rl.peak_mem_bytes == 7 and rl.arg_bytes == 5
