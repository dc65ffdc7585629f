"""LLM-scale DS-FL and FedAvg training and lockstep serving of the two
modality families in the port, against the reference: phi-3-vision-4.2b
(patch features prepended through the projector) and whisper-small (frame
embeddings through the encoder), each at its smoke config (float32), K =
2, batch 2, seq 16, from the reference's client-stacked init carried
across by ``convert``, with tokens and modality inputs drawn with numpy
and the reference's open batches injected: one DS-FL round through each
package's `FedEngine` (the port with ``use_kernel`` both ways: the
kernels' plain versions on the CPU) and one FedAvg round.  Then
``build_lm_task``'s ``extras_fn`` (broadcast over the clients, shared with
the open set, drawn from the task's generator), the launchers' ``main`` on
both archs, and lockstep serving: phi-3-vision's tokens equal to the
reference's ``serve``; whisper's first token equal to the reference's,
and every later one the greedy token of the reference's own teacher-forced
decoder, since the reference's audio prefill leaves the decoder's rings
empty (ROADMAP, deviation 16).

Tolerances as in tests/test_torch_dense_train.py: leaves and loss after
one round at atol 1e-5 (the loss with rtol 1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import llm_dsfl as J
from repro.core.engine import FedEngine as JEngine
from repro.core.llm_algorithms import LLMDSFLAlgorithm as JDSFL
from repro.data.pipeline import FederatedLMTask as JTask
from repro.launch import serve as jserve
from repro.models import api as japi
from repro.models import encdec as JE
from repro_torch.configs import get_config
from repro_torch.core import llm_dsfl as T
from repro_torch.core.engine import FedEngine
from repro_torch.core.llm_algorithms import (LLMDSFLAlgorithm,
                                             LLMFedAvgAlgorithm, LLMFedAvgHP)
from repro_torch.data.pipeline import (FederatedLMTask, build_lm_task,
                                      lm_open_batch, lm_private_batches)
from repro_torch.launch import serve, train

from test_torch_convert import assert_flat_close, to_port
from test_torch_llm_algorithms import _ref_open_batches
from test_torch_convert import one_intra_op_thread  # noqa: F401

ARCHS = ["phi-3-vision-4.2b", "whisper-small"]
EXTRA = {"vlm": "patches", "audio": "frames"}
K, B, S = 2, 2, 16
CPU = "cpu"
TOL = 1e-5


def _extra_len(cfg):
    return cfg.n_patches if cfg.arch_type == "vlm" else cfg.n_audio_frames


@pytest.fixture(scope="module", params=ARCHS)
def setup(request):
    arch = request.param
    jcfg, cfg = jget_config(arch).smoke(), get_config(arch).smoke()
    jst = jax.jit(jax.vmap(lambda k: japi.model_init(jcfg, k)))(
        jax.random.split(jax.random.PRNGKey(0), K))
    rng = np.random.default_rng(0)
    pt = rng.integers(0, cfg.vocab, (K, B, S))
    ot = rng.integers(0, cfg.vocab, (B, S))
    ex = rng.standard_normal((B, _extra_len(cfg), cfg.d_model)).astype(
        np.float32)
    name = EXTRA[cfg.arch_type]
    jx = jnp.asarray(ex)
    jtask = JTask({"tokens": jnp.asarray(pt, jnp.int32),
                   name: jnp.broadcast_to(jx[None], (K,) + ex.shape)},
                  {"tokens": jnp.asarray(ot, jnp.int32), name: jx})
    tx = torch.from_numpy(ex)
    task = FederatedLMTask({"tokens": torch.as_tensor(pt),
                            name: tx[None].expand((K,) + ex.shape)},
                           {"tokens": torch.as_tensor(ot), name: tx})
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jst=jst, tst=to_port(jst),
                jtask=jtask, task=task)


@pytest.fixture(scope="module")
def ref_rounds(setup):
    """The reference's DS-FL engine round and FedAvg round."""
    jcfg, jst, jtask = setup["jcfg"], setup["jst"], setup["jtask"]
    algo = JDSFL(jcfg, J.LLMDsflHP(lr=5e-3, rounds=1, seed=0, open_batch=B))
    eng = JEngine(algo)
    out = eng.run(algo.init_from(jst), jtask, rounds=1)
    fedavg = jax.jit(lambda p, pb: J.fedavg_round_step(jcfg, p, pb, 1e-3))(
        jst, jtask.x_clients)
    return (out.clients.params, eng.history[0]["loss"]), fedavg


@pytest.mark.parametrize("use_kernel", [False, True])
def test_dsfl_engine_round_matches_reference(setup, ref_rounds, use_kernel):
    cfg = setup["cfg"]
    algo = LLMDSFLAlgorithm(cfg, T.LLMDsflHP(
        lr=5e-3, rounds=1, seed=0, open_batch=B, use_kernel=use_kernel),
        device=CPU)
    eng = FedEngine(algo)
    out = eng.run(algo.init_from(setup["tst"]), setup["task"], rounds=1,
                  draws=_ref_open_batches(algo.hp, setup["jtask"], 1))
    (jparams, jloss), _ = ref_rounds
    assert_flat_close(out.clients.params, jparams, TOL)
    np.testing.assert_allclose(eng.history[0]["loss"], float(jloss),
                               atol=TOL, rtol=1e-6)


def test_fedavg_engine_round_matches_reference(setup, ref_rounds):
    algo = LLMFedAvgAlgorithm(setup["cfg"], LLMFedAvgHP(lr=1e-3, rounds=1),
                              device=CPU)
    eng = FedEngine(algo)
    out = eng.run(algo.init_from(setup["tst"]), setup["task"], rounds=1)
    _, (jparams, jloss) = ref_rounds
    assert_flat_close(out.clients.params, jparams, TOL)
    np.testing.assert_allclose(eng.history[0]["loss"], float(jloss),
                               atol=TOL, rtol=1e-6)
    for k, v in out.clients.params.items():
        assert torch.equal(v[0], v[1]), k


# ----------------------------------------------------------------- data ----
@pytest.mark.parametrize("arch", ARCHS)
def test_extras_fn_broadcast_and_shared_with_the_open_set(arch):
    """``launch.train.extra_inputs`` through ``build_lm_task``: one draw of
    (batch, n, d) from the task's generator after the tokens, a stride-0
    view over the K clients, the same tensor in the open set; the tokens
    are those of the task without extras."""
    cfg = get_config(arch).smoke()
    name = EXTRA[cfg.arch_type]
    task = build_lm_task(3, 3, 2, 8, cfg.vocab, device=CPU,
                         extras_fn=lambda b, g: train.extra_inputs(cfg, b, g))
    plain = build_lm_task(3, 3, 2, 8, cfg.vocab, device=CPU)
    for part in ("x_clients", "open_x"):
        assert torch.equal(getattr(task, part)["tokens"],
                           getattr(plain, part)["tokens"])
    x = task.open_x[name]
    assert tuple(x.shape) == (2, _extra_len(cfg), cfg.d_model)
    assert x.dtype == cfg.cdtype
    xc = task.x_clients[name]
    assert tuple(xc.shape) == (3,) + tuple(x.shape) and xc.stride(0) == 0
    assert xc.data_ptr() == x.data_ptr()
    # drawn from the task's generator after the private and open tokens
    g = torch.Generator().manual_seed(3)
    lm_private_batches(g, 3, 2, 8, cfg.vocab)
    lm_open_batch(g, 2, 8, cfg.vocab)
    assert torch.equal(train.extra_inputs(cfg, 2, g)[name], x)
    assert train.extra_inputs(get_config("qwen1.5-4b").smoke(), 2, g) == {}


# ----------------------------------------------------------- launchers ----
@pytest.mark.parametrize("mode", ["dsfl", "fedavg", "local"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_runs_the_modality_archs(arch, mode, capsys):
    train.main(["--arch", arch, "--mode", mode, "--smoke", "--device", "cpu",
                "--clients", "2", "--batch", "2", "--seq", "16",
                "--steps", "2"])
    out = capsys.readouterr().out
    kind = get_config(arch).arch_type
    assert f"arch={arch} ({kind}) layers=2 d=128 vocab=512 device=cpu" in out
    lines = [l for l in out.splitlines()
             if l.startswith(("round", "step"))]
    assert len(lines) == 2
    assert all(np.isfinite(float(l.split("loss")[1].split()[0]))
               for l in lines)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_the_modality_archs_on_the_lockstep_path(arch,
                                                                 capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                "--prompt-len", "8", "--gen", "4"])
    out = capsys.readouterr().out
    assert "[lockstep] generated (2, 4) tokens on cpu" in out


def test_lockstep_serve_matches_reference():
    """Both models' lockstep serve of 2 prompts of 8 tokens, 6 new tokens,
    from the reference's weights.  phi-3-vision: the tokens of the
    reference's ``serve`` (decode from 8 + 16 patches).  whisper: the first
    token of the reference's ``serve``; each later one the argmax of the
    reference's teacher-forced decoder over the prompt and the tokens
    before it (the reference's own ``serve`` decodes against empty rings)."""
    rng = np.random.default_rng(5)
    gen = 6
    for arch in ARCHS:
        jcfg, cfg = jget_config(arch).smoke(), get_config(arch).smoke()
        jp = jax.jit(lambda k: japi.model_init(jcfg, k))(
            jax.random.PRNGKey(1))
        toks = rng.integers(0, cfg.vocab, (2, 8)).astype(np.int32)
        ex = rng.standard_normal((2, _extra_len(cfg), cfg.d_model)).astype(
            np.float32)
        name = EXTRA[cfg.arch_type]
        budget = 8 + gen + (cfg.n_patches if cfg.arch_type == "vlm" else 0)
        want, _ = jserve.serve(jcfg, jp, {"tokens": jnp.asarray(toks),
                                          name: jnp.asarray(ex)}, gen, budget)
        want = np.asarray(want)
        got, _ = serve.serve(cfg, to_port(jp), {
            "tokens": torch.from_numpy(toks).long(),
            name: torch.from_numpy(ex)}, gen, budget)
        got = got.numpy()
        assert got.shape == (2, gen)
        if cfg.arch_type == "vlm":
            np.testing.assert_array_equal(got, want)
            continue
        np.testing.assert_array_equal(got[:, 0], want[:, 0])
        enc = JE.encode(jcfg, jp, jnp.asarray(ex), remat=False)
        seq = np.concatenate([toks, got[:, :-1]], axis=1)
        forced = JE.decoder_logits(jcfg, jp, jnp.asarray(seq), enc,
                                   remat=False)
        np.testing.assert_array_equal(
            got, np.asarray(jnp.argmax(forced[:, 7:], -1)))
