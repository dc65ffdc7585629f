"""LLM-scale DS-FL and FedAvg training of the MoE family in the port
against the reference: llama4-scout-17b-a16e's smoke config (2 layers, d
128, 4 experts top-1 in groups of 16, vocab 512, float32), K = 2, batch 2,
seq 16, from the reference's client-stacked init carried across by
``convert``, tokens drawn with numpy and the reference's open batches
injected: one DS-FL ERA round through each package's `FedEngine` and
LLM DS-FL algorithm (the port with ``use_kernel`` both ways: the kernels'
plain versions on the CPU), whose local step carries the MoE load-balance
term and drops (token, choice) pairs at the config's capacity, and one
FedAvg round.  Then the trainer's ``main`` on scout in every mode, and the
full-width two-layer count chip_smoke.py trains on the card.

Tolerances as in tests/test_torch_dense_train.py: leaves and loss after
one round at atol 1e-5 (the loss with rtol 1e-6)."""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget_config
from repro.core import llm_dsfl as J
from repro.core.engine import FedEngine as JEngine
from repro.core.llm_algorithms import LLMDSFLAlgorithm as JDSFL
from repro.core.llm_algorithms import LLMFedAvgAlgorithm as JFedAvg
from repro.core.llm_algorithms import LLMFedAvgHP as JFedAvgHP
from repro.data.pipeline import FederatedLMTask as JTask
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.core import llm_dsfl as T
from repro_torch.core.engine import FedEngine
from repro_torch.core.llm_algorithms import (LLMDSFLAlgorithm,
                                             LLMFedAvgAlgorithm, LLMFedAvgHP)
from repro_torch.data.pipeline import FederatedLMTask
from repro_torch.launch import train
from repro_torch.models import api as tapi
from repro_torch.models import moe
from repro_torch.models.base import param_count

from test_torch_convert import assert_flat_close, to_port
from test_torch_llm_algorithms import _ref_open_batches

ARCH = "llama4-scout-17b-a16e"
K, B, S = 2, 2, 16
CPU = "cpu"
TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = jget_config(ARCH).smoke(), get_config(ARCH).smoke()
    assert (cfg.n_experts, cfg.top_k, cfg.moe_group_size) == (4, 1, 16)
    jst = jax.jit(jax.vmap(lambda k: japi.model_init(jcfg, k)))(
        jax.random.split(jax.random.PRNGKey(0), K))
    rng = np.random.default_rng(0)
    pt = rng.integers(0, cfg.vocab, (K, B, S))
    ot = rng.integers(0, cfg.vocab, (B, S))
    jtask = JTask({"tokens": jnp.asarray(pt, jnp.int32)},
                  {"tokens": jnp.asarray(ot, jnp.int32)})
    task = FederatedLMTask({"tokens": torch.as_tensor(pt)},
                           {"tokens": torch.as_tensor(ot)})
    return dict(jcfg=jcfg, cfg=cfg, jst=jst, tst=to_port(jst), jtask=jtask,
                task=task)


@pytest.fixture(scope="module")
def ref_rounds(setup):
    """The reference's DS-FL ERA engine round and FedAvg engine round."""
    jcfg, jst, jtask = setup["jcfg"], setup["jst"], setup["jtask"]
    out = {}
    for name, algo in (
            ("dsfl", JDSFL(jcfg, J.LLMDsflHP(lr=5e-3, rounds=1, seed=0,
                                             open_batch=B))),
            ("fedavg", JFedAvg(jcfg, JFedAvgHP(lr=1e-3, rounds=1)))):
        eng = JEngine(algo)
        state = eng.run(algo.init_from(jst), jtask, rounds=1)
        out[name] = (state.clients.params, eng.history[0]["loss"])
    return out


def _dropped(fn):
    """``fn()`` with `moe.route` counting the (token, choice) pairs past
    capacity; returns (``fn()``, the count)."""
    route, n = moe.route, [0]

    def counting(p, c, xg):
        out = route(p, c, xg)
        n[0] += int((~out[3]).sum())
        return out

    with mock.patch.object(moe, "route", counting):
        return fn(), n[0]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_dsfl_engine_round_matches_reference(setup, ref_rounds, use_kernel):
    algo = LLMDSFLAlgorithm(setup["cfg"], T.LLMDsflHP(
        lr=5e-3, rounds=1, seed=0, open_batch=B, use_kernel=use_kernel),
        device=CPU)
    assert algo.hp.aux_weight == J.LLMDsflHP().aux_weight == 0.01
    eng = FedEngine(algo)
    out, dropped = _dropped(lambda: eng.run(
        algo.init_from(setup["tst"]), setup["task"], rounds=1,
        draws=_ref_open_batches(algo.hp, setup["jtask"], 1)))
    assert dropped > 0
    jparams, jloss = ref_rounds["dsfl"]
    assert_flat_close(out.clients.params, jparams, TOL)
    np.testing.assert_allclose(eng.history[0]["loss"], float(jloss),
                               atol=TOL, rtol=1e-6)


def test_dsfl_step_carries_the_aux_term(setup):
    """The hybrid step's loss is CE + aux_weight x aux + gamma x KD: with
    the aux term weighted up the loss moves by the difference, and the
    router's gradient changes."""
    cfg, st = setup["cfg"], setup["tst"]
    private = T.client(setup["task"].x_clients, 0)
    open_b = setup["task"].open_x
    (probs,) = T.dsfl_exchange(cfg, st, open_b, T.LLMDsflHP())
    teacher = T._aggregate_teacher(probs, T.LLMDsflHP(), None)
    p0 = T.client(st, 0)
    losses, routers = [], []
    for w in (0.0, 1.0):
        hp = T.LLMDsflHP(lr=5e-3, aux_weight=w, use_kernel=True)
        new, loss = T.dsfl_client_step(cfg, p0, private, open_b, teacher, hp)
        losses.append(float(loss))
        routers.append(new["blocks/s0_ffn/router"])
    with torch.no_grad():
        _, aux = tapi.model_logits(cfg, p0, private)
    assert float(aux) > 0
    assert losses[1] - losses[0] == pytest.approx(float(aux), abs=1e-5)
    assert not torch.equal(routers[0], routers[1])


def test_fedavg_engine_round_matches_reference(setup, ref_rounds):
    algo = LLMFedAvgAlgorithm(setup["cfg"], LLMFedAvgHP(lr=1e-3, rounds=1),
                              device=CPU)
    eng = FedEngine(algo)
    out = eng.run(algo.init_from(setup["tst"]), setup["task"], rounds=1)
    jparams, jloss = ref_rounds["fedavg"]
    assert_flat_close(out.clients.params, jparams, TOL)
    np.testing.assert_allclose(eng.history[0]["loss"], float(jloss),
                               atol=TOL, rtol=1e-6)
    for k, v in out.clients.params.items():
        assert torch.equal(v[0], v[1]), k


@pytest.mark.parametrize("mode", ["dsfl", "fedavg", "local"])
def test_train_main_runs_llama4_scout(mode, capsys):
    train.main(["--arch", ARCH, "--mode", mode, "--smoke", "--device", CPU,
                "--clients", "2", "--batch", "2", "--seq", "16",
                "--steps", "1"])
    out = capsys.readouterr().out
    assert f"arch={ARCH} (moe) layers=2 d=128 vocab=512 device=cpu" in out
    lines = [l for l in out.splitlines()
             if l.startswith(("round", "step"))]
    assert len(lines) == 1
    assert np.isfinite(float(lines[0].split("loss")[1].split()[0]))


def test_full_width_two_layer_count():
    """What chip_smoke.py's phase "moe train" holds on the card: scout at
    its full widths and 2 of its 48 layers, counted under fake tensors:
    5,187,036,160 values, 10,374,451,200 bytes in bf16; the reference's
    init has the same leaves."""
    jcfg = jget_config(ARCH).replace(n_layers=2)
    shapes = jax.eval_shape(lambda k: japi.model_init(jcfg, k),
                            jax.random.PRNGKey(0))
    with FakeTensorMode():
        own = tapi.model_init(get_config(ARCH).replace(n_layers=2),
                              torch.Generator(), CPU)
        assert param_count(own) == 5_187_036_160
        assert sum(v.numel() * v.element_size()
                   for v in own.values()) == 10_374_451_200
        got = {k: tuple(v.shape) for k, v in own.items()}
    assert got == {"/".join(p.key for p in path): tuple(v.shape)
                   for path, v in jax.tree_util.tree_flatten_with_path(
                       shapes)[0]}
