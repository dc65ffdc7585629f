"""The dense family's decode step under a tensor-parallel plan (the other
families': tests/test_torch_tp_families.py)
(`models.transformer.decode_step` over `launch.tp`, run by
`launch.decode_check`) over gloo worlds on the CPU, against the same greedy
decode in one process and against the reference's `model_decode_step`.

Cases (smoke configs, float32; a start token then greedy tokens from an
empty cache: 8 of them in a cache of 16 positions, or enough to fill
every rank's slots where the window is split):

  * "heads": phi3-medium-14b's cut to 4 query over 2 key/value heads on
    (1, 1, 2): heads, MLP and vocabulary split over "model", the ring
    whole on each rank;
  * "fsdp": qwen1.5-4b's (QKV bias) on (1, 2, 1), batch 2: leaves and
    batch over "data";
  * "ring_data": the same with ``fsdp=False`` at batch 1, 15 tokens: the
    ring's window of 16 split over "data";
  * "ring_model": phi3's cut to 8 over 2 heads on (1, 1, 4), 23 tokens: 2
    key/value heads do not split 4 ways, so attention is replicated and
    the window of 24 split over "model", 6 slots a rank (which do not
    split 4 ways themselves: the step takes the window from the cache's
    ``seq_len``, not from the slots a rank holds).

Held: every rank's greedy tokens equal and its rows' logits within 1e-5
of the largest one-process logit; the one-process decode against the
reference's, the same way; each rank's collectives of a step, by axis,
equal to `tp.decode_bytes`; a 1% fault in one rank's ``wo`` slice or in
its ring slice, planted before a late step, fails the check."""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import decode_check as dc
from repro_torch.launch import dist, tp
from repro_torch.models import api as tapi
from repro_torch.models import transformer as T
from repro_torch.models.shardctx import active_plan

from test_torch_convert import one_intra_op_thread  # noqa: F401

PHI3, QWEN = "phi3-medium-14b", "qwen1.5-4b"
CASES = {
    "heads": dc.DecodeSpec(arch=PHI3, overrides=(("n_heads", 4),
                                                 ("n_kv_heads", 2)),
                           mesh_shape=(1, 1, 2)),
    "fsdp": dc.DecodeSpec(arch=QWEN, mesh_shape=(1, 2, 1)),
    "ring_data": dc.DecodeSpec(arch=QWEN, mesh_shape=(1, 2, 1), fsdp=False,
                               batch=1, steps=15),
    "ring_model": dc.DecodeSpec(arch=PHI3, overrides=(("n_heads", 8),
                                                      ("n_kv_heads", 2)),
                                mesh_shape=(1, 1, 4), steps=23),
}
FAULTS = {"heads": "wo", "ring_data": "ring", "ring_model": "ring"}
RTOL = 1e-5


def _world(spec) -> int:
    return int(np.prod(spec.mesh_shape))


@pytest.fixture(scope="module")
def ranks():
    """{(case, fault or None): each rank's record}, one spawn a world
    size, the spawns at once."""
    runs = [(c, None) for c in CASES] + list(FAULTS.items())
    worlds = sorted({_world(s) for s in CASES.values()})
    mine = {w: [r for r in runs if _world(CASES[r[0]]) == w] for w in worlds}

    def world_run(world):
        specs = tuple(dataclasses.replace(CASES[c], fault=f)
                      for c, f in mine[world])
        return dist.spawn(dc.rank_main, world, specs, "cpu", backend="gloo")
    with ThreadPoolExecutor(len(worlds)) as pool:
        recs = dict(zip(worlds, pool.map(world_run, worlds)))
    return {key: [rk[i] for rk in recs[w]] for w in worlds
            for i, key in enumerate(mine[w])}


@pytest.fixture(scope="module")
def ones():
    return {c: dc.greedy(s, dc.init_params(s, "cpu"), "cpu")
            for c, s in CASES.items()}


def _reference(spec: dc.DecodeSpec) -> dict:
    """The same greedy decode through the reference's model_decode_step
    (the port's seeded weights converted), one scalar position a step."""
    jcfg = jget_config(spec.arch).smoke().replace(**dict(spec.overrides))
    params = jax.tree.map(jnp.asarray, convert.to_numpy_tree(
        dc.init_params(spec, "cpu")))
    step = jax.jit(functools.partial(japi.model_decode_step, jcfg))
    cache = japi.model_init_cache(jcfg, None, spec.batch, spec.seq_len)
    toks = dc.prompt_tokens(spec, "cpu").numpy().astype(np.int32)
    token, out, logits = toks[:, 0], [toks[:, 0]], []
    for p in range(spec.prompt + spec.steps - 1):
        lg, cache = step(params, cache, jnp.asarray(token), jnp.int32(p))
        logits.append(np.asarray(lg, np.float32))
        token = (toks[:, p + 1] if p + 1 < spec.prompt
                 else np.asarray(jnp.argmax(lg, -1), np.int32))
        if p + 1 >= spec.prompt:
            out.append(token)
    return dict(tokens=torch.from_numpy(np.stack(out, 1).astype(np.int64)),
                logits=torch.from_numpy(np.stack(logits)))


@pytest.mark.parametrize("case", list(CASES))
def test_decode_under_plan_matches_one_process(case, ranks, ones):
    spec = CASES[case]
    want = tp.decode_bytes(spec.config(), spec.mesh_shape, batch=spec.batch,
                           window=spec.seq_len, fsdp=spec.fsdp)
    for r, rec in enumerate(ranks[(case, None)]):
        got = dc.compare(rec, ones[case], RTOL)
        assert got["ok"], (case, r, got)
        assert rec["step_bytes"] == want, (case, r)
        assert rec["logits"].shape[-1] == spec.config().vocab


@pytest.mark.parametrize("case", list(CASES))
def test_one_process_decode_matches_reference(case, ones):
    ref = _reference(CASES[case])
    got = dc.compare(dict(ones[case], rows=(0, CASES[case].batch)), ref,
                     RTOL)
    assert got["ok"], (case, got)


@pytest.mark.parametrize("case", list(FAULTS))
def test_planted_fault_fails_the_check(case, ranks, ones):
    """Rank 1's slice 1% off before a late step: the check fails on some
    rank, while the same run without it passes."""
    checks = [dc.compare(rec, ones[case], RTOL)
              for rec in ranks[(case, FAULTS[case])]]
    assert not all(c["ok"] for c in checks), (case, checks)
    assert max(c["max_abs"] / c["bound"] for c in checks) > 1, checks


def test_layouts_of_the_cases():
    """What each case exercises, read off the plan's ring layout."""
    mesh = lambda shape: SimpleNamespace(axis_names=("pod", "data", "model"),
                                         devices=np.empty(shape))
    got = {}
    for case, s in CASES.items():
        cfg = s.config()
        got[case] = tp._ring_spec(cfg, mesh(s.mesh_shape), s.batch,
                                  s.seq_len)
    assert got["heads"] == (None, None, None, "model", None)
    assert got["fsdp"] == (None, "data", None, None, None)
    assert got["ring_data"] == (None, None, "data", None, None)
    assert got["ring_model"] == (None, None, "model", None, None)


def _plan(mesh_shape) -> tp.TPPlan:
    """Rank 0's plan on a mesh of ``mesh_shape`` with no process group
    (attention replicated): enough for the checks made before any
    collective."""
    mesh = SimpleNamespace(axis_names=("pod", "data", "model"),
                           devices=np.empty(mesh_shape))
    group = lambda n: SimpleNamespace(size=n, rank=0)
    return tp.TPPlan(mesh=mesh, data=group(mesh_shape[1]),
                     model=group(mesh_shape[2]), attn_tp=False, mlp_tp=True,
                     vocab_tp=True, specs={}, data_dims={})


def test_other_families_and_prefill_refused_under_a_plan():
    """Under a plan the VLM decodes (on a fake world of two "model" ranks,
    whose collectives return at once: the step runs on the rank's slices
    and gives its rows' whole-vocabulary logits; the values are
    tests/test_torch_tp_modality.py's, over gloo); nothing prefills."""
    from repro_torch.launch import dryrun
    vlm = get_config("phi-3-vision-4.2b").smoke()
    dense = get_config(QWEN).smoke()
    tok = torch.zeros((2,), dtype=torch.int64)
    try:
        plan = tp.plan_for(vlm, dryrun.fake_world(device="cpu",
                                                  shape=(1, 1, 2)))
        params = plan.slices(tapi.model_init(
            vlm, torch.Generator().manual_seed(0), "cpu"))
        with torch.no_grad(), active_plan(plan):
            cache = tapi.model_init_cache(vlm, params, 2, 8)
            assert cache["s0/k"].shape[3] == vlm.eff_kv_heads // 2
            logits, _ = tapi.model_decode_step(vlm, params, cache, tok, 0, 8)
        assert tuple(logits.shape) == (2, vlm.eff_vocab)
    finally:
        dryrun.close_world()
    with active_plan(_plan((1, 1, 2))):
        with pytest.raises(NotImplementedError, match="prefill"):
            tapi.model_prefill(dense, {}, {"tokens": tok[:, None]})


def test_decode_under_a_plan_takes_the_window_from_seq_len():
    """"ring_model"'s rank holds 6 slots of a ring of 24 split over 4
    "model" ranks; 6 slots would as well be a ring of 6 kept whole.  The
    step under a plan reads the window from the ``seq_len`` the cache was
    made for, and refuses none or one whose layout gives another number
    of slots."""
    spec = CASES["ring_model"]
    cfg = spec.config()
    tok = torch.zeros((spec.batch,), dtype=torch.int64)
    with active_plan(_plan(spec.mesh_shape)):
        cache = T.init_cache(cfg, spec.batch, spec.seq_len, "cpu")
        assert spec.seq_len == 24 and cache["s0/k"].shape[2] == 6
        with pytest.raises(ValueError, match="seq_len"):
            tapi.model_decode_step(cfg, {}, cache, tok, 0)
        with pytest.raises(ValueError, match="slots"):
            tapi.model_decode_step(cfg, {}, cache, tok, 0, 16)
