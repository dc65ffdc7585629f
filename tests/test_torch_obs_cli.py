"""The launchers' ``--trace`` / ``--metrics`` (`repro_torch.obs.cli`), the
run's provenance stamp (`obs.provenance`) and the Perfetto converter
(`obs.perfetto`), on the CPU.

The port's converter and validator give the reference's output on the same
JSONL (one the reference's tracer wrote, and one the port's wrote); the
train and serve launchers and examples/torch_sim_stragglers.py write a
trace whose header carries the provenance and a snapshot that holds their
counters; with neither flag the session installs nothing; and no module of
``repro_torch.obs`` imports JAX or the reference."""
import json
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import pytest

from repro.obs import perfetto as jperfetto
from repro.obs import trace as jtrace
from repro_torch import obs
from repro_torch.launch import serve, train
from repro_torch.obs import cli as obs_cli
from repro_torch.obs import perfetto
from repro_torch.obs import trace as ttrace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import torch_sim_stragglers  # noqa: E402

PROVENANCE_KEYS = {"git_sha", "git_dirty", "torch_version", "cuda_version",
                   "driver_version", "gpu_name", "gpu_power_limit",
                   "n_devices", "tf32_matmul", "tf32_cudnn", "kernel_route",
                   "platform_preset", "platform", "python", "argv"}


def _write(tracer_mod, path):
    """A small trace through a package's tracer: nested spans on two
    layers, an instant, span arguments."""
    t = tracer_mod.Tracer(str(path))
    with t.span("engine.chunk", "engine", rounds=2):
        with t.span("wire.measure", "wire", codec="fp16") as sp:
            sp.set(up_bytes=10)
        t.instant("queue.shed", "queue", req=3)
    t.close()
    return path


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_perfetto_conversion_equals_the_reference(writer, tmp_path):
    path = _write(jtrace if writer == "reference" else ttrace,
                  tmp_path / "t.jsonl")
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    assert perfetto.to_perfetto(str(path), str(ours)) == \
        jperfetto.to_perfetto(str(path), str(theirs)) == 4
    assert json.loads(ours.read_text()) == json.loads(theirs.read_text())
    summary = perfetto.validate(str(path), require_layers={"engine", "wire"})
    assert (summary["spans"], summary["instants"]) == (2, 1)
    assert summary["layers"] == ["engine", "queue", "wire"]
    if writer == "reference":        # the reference's validator wants jax's
        assert summary == jperfetto.validate(str(path))
    else:
        assert set(summary["provenance"]) == PROVENANCE_KEYS
    with pytest.raises(ValueError, match="missing required layers"):
        perfetto.validate(str(path), require_layers={"serve"})


def test_validate_refuses_a_trace_without_provenance(tmp_path):
    path = tmp_path / "bad.jsonl"
    path.write_text(json.dumps({"type": "meta", "t0_ns": 0}) + "\n")
    with pytest.raises(ValueError, match="provenance"):
        perfetto.validate(str(path))


def _run_train(argv):
    train.main(["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
                "--clients", "2", "--batch", "2", "--seq", "16",
                "--steps", "2"] + argv)


def _run_serve(argv):
    serve.main(["--arch", "qwen1.5-4b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "8", "--gen", "4"] + argv)


def _run_sim(argv):
    assert torch_sim_stragglers.main(["--fast", "--device", "cpu"] + argv) == 0


LAUNCHERS = {
    "train": (_run_train, {"engine", "wire"}, "engine.rounds"),
    "serve": (_run_serve, {"serve"}, "serve.decode_steps"),
    "sim": (_run_sim, {"engine", "sim", "wire"}, "sim.participant_rounds"),
}


@pytest.mark.parametrize("which", sorted(LAUNCHERS))
def test_launcher_writes_trace_and_metrics(which, tmp_path, capsys):
    run, layers, counter = LAUNCHERS[which]
    tr, mt = tmp_path / "t.jsonl", tmp_path / "m.json"
    run(["--trace", str(tr), "--metrics", str(mt)])
    out = capsys.readouterr().out
    assert f"trace: {tr}" in out and f"metrics snapshot: {mt}" in out
    summary = perfetto.validate(str(tr), require_layers=layers)
    prov = summary["provenance"]
    assert set(prov) == PROVENANCE_KEYS
    assert prov["kernel_route"] == "plain" and prov["torch_version"]
    doc = json.loads(mt.read_text())
    assert doc["provenance"] == prov
    assert doc["metrics"][counter] > 0
    assert obs.trace._TRACER is None and obs.current_registry() is None


def test_no_flag_installs_nothing():
    with obs_cli.session(Namespace(device="cpu")) as s:
        assert obs.trace._TRACER is None and obs.current_registry() is None
        assert s._provenance is None
    args = train.parse_args(["--smoke", "--device", "cpu"])
    assert args.trace is None and args.metrics is None


def test_obs_imports_neither_jax_nor_the_reference():
    """Importing every module of ``repro_torch.obs`` and collecting the
    provenance loads no JAX and nothing of ``repro``."""
    code = (
        "import sys\n"
        "import repro_torch.obs, repro_torch.obs.cli, repro_torch.obs.perfetto\n"
        "from repro_torch.obs.provenance import RunProvenance\n"
        "RunProvenance.collect('cpu')\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(ROOT))
