"""The port's live weight hot-swap (`repro_torch.serve.swap`), mirroring
tests/test_serve.py's hot-swap tests: a live `FedEngine` running LLM DS-FL
on the smoke-size qwen1.5-4b swaps the server's weights after each round
(responses before carry version 0, after it the last round's number, and
the served weights are bitwise ``algo.eval_params(state)`` and never alias
the trainer's tensors), ``every=2`` thins the swaps, a mismatched tree
raises naming its leaves, a params file written by the reference's
``save_pytree`` swaps in, and the ``swap.sync`` span and the
``swap.latency_s`` histogram are recorded."""
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import save_pytree as j_save_pytree
from repro.configs import get_config as jget_config
from repro.models import transformer as JT
from repro_torch import obs
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_config
from repro_torch.core.engine import FedEngine
from repro_torch.core.llm_algorithms import LLMDSFLAlgorithm, stack_init
from repro_torch.core.llm_dsfl import LLMDsflHP
from repro_torch.data.pipeline import build_lm_task
from repro_torch.models.api import model_init
from repro_torch.serve import (Request, ServeEngine, attach,
                               swap_from_checkpoint)

from test_torch_convert import to_port
from test_torch_convert import one_intra_op_thread  # noqa: F401

CPU = "cpu"
QWEN = get_config("qwen1.5-4b").smoke()
BUCKETS, BUDGET = (8, 16), 48
K, B, S = 2, 4, 32


def _init(seed):
    return model_init(QWEN, torch.Generator().manual_seed(seed), CPU)


def _server(seed=1, slots=2):
    return ServeEngine(QWEN, _init(seed), slots=slots, seq_budget=BUDGET,
                       buckets=BUCKETS, device=CPU)


def _federation():
    task = build_lm_task(0, K, B, S, QWEN.vocab, device=CPU)
    algo = LLMDSFLAlgorithm(QWEN, LLMDsflHP(lr=5e-3, rounds=2, seed=0,
                                            open_batch=B), device=CPU)
    state = algo.init_from(stack_init(0, lambda g: model_init(QWEN, g, CPU),
                                      K, CPU))
    return task, algo, FedEngine(algo), state


def _serve_one(srv, rid, prompt):
    srv.insert(Request(id=rid, tokens=prompt, max_new_tokens=4))
    out = []
    while srv.n_active:
        out.extend(srv.step())
    (r,) = out
    return r


def _prompt(n=12, seed=3):
    g = np.random.default_rng(seed)
    return tuple(int(t) for t in g.integers(0, QWEN.vocab, size=n))


def test_hot_swap_from_live_fed_engine():
    """Train-while-serving: every round of a FedEngine LLM DS-FL run
    hot-swaps the server's weights."""
    task, algo, fed, state = _federation()
    srv = _server()
    served = {k: v.clone() for k, v in srv.params.items()}
    before = _serve_one(srv, 0, _prompt())
    assert before.weights_version == 0

    sync = attach(fed, srv, algo)
    assert fed.on_chunk is sync
    state = fed.run(state, task, rounds=2)
    assert [r for r, _ in sync.swap_log] == [1, 2]
    assert all(dt >= 0 for _, dt in sync.swap_log)
    assert sync.last_swap_s == sync.swap_log[-1][1]
    assert srv.version == 2 and srv.n_swaps == 2

    after = _serve_one(srv, 1, _prompt())
    assert after.weights_version == 2
    assert not torch.equal(srv.params["blocks/s0_mix/wq"],
                           served["blocks/s0_mix/wq"])

    # the served weights ARE the trained global model, in the server's
    # own storage
    want, _ = algo.eval_params(state)
    for k, v in want.items():
        assert torch.equal(srv.params[k], v), k
    stack = state.clients.params
    for k, v in srv.params.items():
        assert v.untyped_storage().data_ptr() != \
            stack[k].untyped_storage().data_ptr(), k


def test_every_two_swaps_once():
    task, algo, fed, state = _federation()
    srv = _server()
    sync = attach(fed, srv, algo, every=2)
    fed.run(state, task, rounds=2)
    assert [r for r, _ in sync.swap_log] == [2]
    assert srv.version == 2 and srv.n_swaps == 1


def test_swap_mismatch_names_leaves():
    srv = _server()
    bad = _init(2)
    bad["blocks/s0_mix/wq"] = bad["blocks/s0_mix/wq"][..., :1]
    del bad["final_norm/scale"]
    with pytest.raises(ValueError, match="blocks/s0_mix/wq") as e:
        srv.swap_weights(bad)
    assert "missing leaf final_norm/scale" in str(e.value)
    assert srv.version == 0 and srv.n_swaps == 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_swap_from_checkpoint(tmp_path, writer):
    """A params file from either package swaps in (the reference's nested
    tree flattened to the port's names)."""
    srv = _server()
    path = str(tmp_path / "weights.msgpack")
    if writer == "reference":
        jcfg = jget_config("qwen1.5-4b").smoke()
        jp = jax.jit(lambda k: JT.init_lm(jcfg, k))(jax.random.PRNGKey(3))
        j_save_pytree(path, jp)
        new = to_port(jp)
    else:
        new = _init(4)
        save_pytree(path, new)
    dt = swap_from_checkpoint(srv, path, version=7)
    assert dt >= 0 and srv.version == 7
    for k, v in new.items():
        assert torch.equal(srv.params[k], v), k


def test_swap_records_span_and_histogram(tmp_path):
    task, algo, fed, state = _federation()
    srv = _server()
    sync = attach(fed, srv, algo)
    reg = obs.MetricsRegistry()
    prev = obs.install_registry(reg)
    try:
        with obs.trace_to(str(tmp_path / "t.jsonl")):
            fed.run(state, task, rounds=1)
    finally:
        obs.install_registry(prev)
    spans = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    swaps = [e for e in spans if e.get("name") == "swap.sync"]
    assert len(swaps) == 1
    args = swaps[0]["args"]
    assert args["round"] == 1 and args["serve_steps"] == srv.n_steps
    assert args["swap_s"] == sync.swap_log[0][1]
    snap = reg.snapshot()
    assert snap["swap.latency_s"]["count"] == 1
