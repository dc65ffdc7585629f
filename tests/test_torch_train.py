"""The port's LLM training entry point (`repro_torch.launch.train`) and its LM
task (`repro_torch.data.pipeline.build_lm_task`).

The entry point runs every mode on ``mamba2-2.7b``'s smoke config on the CPU
(``--device cpu``; the kernels' plain versions), through the direct engine,
chunks, the simulator and a checkpoint, and raises without a card when the
card is asked for (the dense family's runs are in
tests/test_torch_dense_train.py).  The task's draws come from ``torch.Generator`` (the
reference's from ``jax.random``), so it is held to the reference's
invariants rather than its values: shapes, the token range, the chain's
structure, domain d <-> client d after the stable sort, and the open set's
7 domains."""
import numpy as np
import pytest
import torch

from repro.data.synthetic import make_token_lm as jmake_token_lm
from repro_torch.data import synthetic
from repro_torch.data.pipeline import (build_lm_task, lm_open_batch,
                                       lm_private_batches)
from repro_torch.launch import train

from test_torch_convert import one_intra_op_thread  # noqa: F401

CPU = "cpu"
SMOKE = ["--arch", "mamba2-2.7b", "--smoke", "--device", CPU, "--clients",
         "2", "--batch", "2", "--seq", "16", "--steps", "2"]


@pytest.mark.parametrize("extra", [
    ["--mode", "dsfl"],
    ["--mode", "dsfl", "--topk", "8", "--aggregation", "sa"],
    ["--mode", "dsfl", "--chunk-rounds", "2", "--overlap"],
    ["--mode", "dsfl", "--participation", "0.5"],
    ["--mode", "fedavg"],
    ["--mode", "fedavg", "--participation", "0.5", "--chunk-rounds", "2"],
    ["--mode", "local"],
], ids=lambda e: "-".join(a.lstrip("-") for a in e))
def test_train_runs_every_mode_on_the_cpu(extra, capsys):
    recs = train.run(train.parse_args(SMOKE + extra))
    out = capsys.readouterr().out
    assert "arch=mamba2-2.7b (ssm) layers=2 d=128 vocab=512" in out
    assert len(recs) == 2 and all(np.isfinite(r["loss"]) for r in recs)
    if "local" not in extra:
        assert "params/client: 284,720" in out and "exchange/round:" in out
        assert out.count("s/round") == 2
    if "--participation" in extra:
        assert all(r["participants"] == 1 for r in recs)


def test_train_exchange_line_and_checkpoint(tmp_path, capsys):
    """fp16 bytes a round: (K + 1) * B * S * V * 2 = 3 * 2 * 16 * 512 * 2;
    FedAvg's: (K + 1) * 4 * params; the checkpoint resumes the engine."""
    path = str(tmp_path / "dsfl.msgpack")
    train.run(train.parse_args(SMOKE + ["--ckpt", path]))
    out = capsys.readouterr().out
    assert "exchange/round: 98.3 kB (FedAvg parameter exchange would be " \
           "3.4 MB)" in out and f"saved {path}" in out
    fed = train.setup(train.parse_args(SMOKE))
    fed.engine.load_state(path, fed.state)
    assert fed.engine.rounds_done == 2
    assert fed.exchange_bytes == 3 * 2 * 16 * 512 * 2
    assert fed.fedavg_bytes == 3 * 4 * fed.params_per_client


def test_train_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("dsfl", "fedavg", "local"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(["--smoke", "--mode", mode, "--steps", "1"])


# ----------------------------------------------------------------- data -----
def test_token_lm_shapes_range_and_chain():
    V, n, S = 97, 64, 40
    toks, dom = synthetic.make_token_lm(torch.Generator().manual_seed(0), n,
                                        S, V, n_domains=4)
    assert toks.shape == (n, S) and dom.shape == (n,)
    assert toks.dtype == torch.int64 and int(toks.min()) >= 0 \
        and int(toks.max()) < V
    assert set(dom.tolist()) == {0, 1, 2, 3}
    # the chain: a token is the previous one's successor (p*7+13) % V about
    # 30% of the time, as in the reference's corpus at the same settings
    succ = (toks[:, :-1] * 7 + 13) % V == toks[:, 1:]
    jt, _ = jmake_token_lm(__import__("jax").random.PRNGKey(0), n, S, V)
    jt = np.asarray(jt)
    jsucc = ((jt[:, :-1] * 7 + 13) % V == jt[:, 1:]).mean()
    assert abs(float(succ.float().mean()) - 0.3) < 0.05
    assert abs(jsucc - 0.3) < 0.05
    # each domain's block of the vocabulary is over-represented in it
    lo = [(V * d) // 4 for d in range(5)]
    for d in range(4):
        inside = (toks >= lo[d]) & (toks < lo[d + 1])
        own, other = inside[dom == d].float().mean(), \
            inside[dom != d].float().mean()
        assert own > 2 * other, (d, float(own), float(other))


def test_private_batches_deal_sorted_domains():
    """Client k's sequences are the k-th block of the domain-sorted corpus:
    the same generator draws the corpus and its domains, stably sorted."""
    K, B, S, V = 3, 4, 12, 61
    got = lm_private_batches(torch.Generator().manual_seed(5), K, B, S, V)
    toks, dom = synthetic.make_token_lm(torch.Generator().manual_seed(5),
                                        K * B, S, V, n_domains=K)
    order = torch.argsort(dom, stable=True)
    assert torch.equal(got["tokens"], toks[order].reshape(K, B, S))
    d = dom[order].reshape(K, B)
    assert bool((d[1:].min(dim=1).values >= d[:-1].max(dim=1).values).all())


def test_open_set_has_seven_domains_and_task_layout():
    gen = torch.Generator().manual_seed(1)
    _, dom = synthetic.make_token_lm(gen, 400, 8, 50, n_domains=7)
    assert set(dom.tolist()) == set(range(7))
    assert lm_open_batch(gen, 5, 8, 50)["tokens"].shape == (5, 8)
    task = build_lm_task(0, 2, 3, 8, 50, device=CPU)
    assert task.x_clients["tokens"].shape == (2, 3, 8)
    assert task.open_x["tokens"].shape == (3, 8) and task.y_clients is None
    assert build_lm_task(0, 2, 3, 8, 50, n_open=6, device=CPU
                         ).open_x["tokens"].shape == (6, 8)
    # modality inputs: drawn once by extras_fn, broadcast over the clients
    # and shared with the open set
    ex = build_lm_task(0, 2, 3, 8, 50, device=CPU, extras_fn=lambda b, g: {
        "frames": torch.randn((b, 4, 5), generator=g)})
    assert torch.equal(ex.x_clients["tokens"], task.x_clients["tokens"])
    assert ex.x_clients["frames"].shape == (2, 3, 4, 5)
    assert torch.equal(ex.x_clients["frames"][1], ex.open_x["frames"])
