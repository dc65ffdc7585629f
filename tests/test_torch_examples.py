"""The examples' torch twins (``examples/torch_*.py``) on the CPU at their
smallest flags, each through its ``main``: the quickstart's DS-FL rounds
with ERA and with weighted ERA (K1 and K2's plain versions), its measured
bytes equal to `CommModel`'s and a final ``OK``; the batched-serving twin
through ``launch.serve --smoke``, step at a time and fused; the LM twin
through ``launch.train --smoke``."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from test_torch_convert import one_intra_op_thread  # noqa: F401

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("aggregation", ["era", "weighted_era"])
def test_quickstart_twin(aggregation, capsys):
    rc = load("torch_quickstart").main(["--fast", "--device", "cpu",
                                        "--aggregation", aggregation])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0 and out[-1] == "OK"
    assert (f"model: 4,394 params | 4 clients | aggregation={aggregation} "
            f"| device=cpu") in out
    comm = next(l for l in out if l.startswith("per-round comm"))
    assert "DS-FL: 64.0 kB" in comm and "top-3 codec: 38.4 kB" in comm
    rounds = [l for l in out if l.startswith("round")]
    assert len(rounds) == 3
    acc = [float(l.split("server acc")[1].split()[0]) for l in rounds]
    assert acc[-1] > 0.25


@pytest.mark.parametrize("extra", [[], ["--decode-chunk", "4",
                                        "--batch-insert"]])
def test_serve_batched_twin(extra, capsys):
    load("torch_serve_batched").main(["--device", "cpu", "--gen", "4"]
                                     + extra)
    out = capsys.readouterr().out
    assert "[continuous] 4 requests, 16 tokens on cpu" in out
    chunk = extra[1] if extra else "1"
    assert f"chunk={chunk}, batch_insert={bool(extra)}" in out


def test_train_dsfl_lm_twin(capsys):
    load("torch_train_dsfl_lm").main(["--smoke", "--steps", "1", "--device",
                                      "cpu"])
    out = capsys.readouterr().out
    assert "arch=qwen1.5-4b (dense) layers=2 d=128 vocab=512 device=cpu" in out
    (line,) = [l for l in out.splitlines() if l.startswith("round")]
    assert np.isfinite(float(line.split("loss")[1].split()[0]))
