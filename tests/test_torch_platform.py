"""The port's platform presets (`repro_torch.launch.platform`, the
counterpart of ``repro/launch/platform.py`` over torch's switches): the
registry, what each preset sets, ``--platform-preset`` on the launchers
and the example, and the provenance stamp.  Every test restores torch's
switches and the active preset (the ``switches`` fixture), since they are
process-wide."""
import argparse

import pytest
import torch

from repro_torch.launch import platform as pf
from repro_torch.obs.provenance import RunProvenance

from test_torch_convert import one_intra_op_thread  # noqa: F401


@pytest.fixture(autouse=True)
def switches():
    saved = pf.snapshot()
    yield saved
    pf.restore(saved)
    assert pf.snapshot() == saved


def _switches():
    s = pf.snapshot()
    del s["active"]
    return s


def test_registry_names():
    assert pf.names() == ["default", "deterministic", "fp32",
                          "fp32-deterministic", "x64"]
    assert all(pf.PRESETS[n].name == n for n in pf.names())


def test_unknown_name_raises_listing_the_names():
    with pytest.raises(ValueError, match="unknown platform preset 'cpu8'; "
                       "available: default, deterministic, fp32, "
                       "fp32-deterministic, x64"):
        pf.apply("cpu8")


TF32_ON = dict(matmul_tf32=True, cudnn_tf32=True)
DET_OFF = dict(cudnn_deterministic=False, cudnn_benchmark=True,
               deterministic=False, warn_only=False)


@pytest.mark.parametrize("name,want", [
    ("default", {}),
    ("fp32", dict(matmul_tf32=False, cudnn_tf32=False)),
    ("deterministic", dict(cudnn_deterministic=True, cudnn_benchmark=False,
                           deterministic=True, warn_only=True)),
    ("fp32-deterministic", dict(matmul_tf32=False, cudnn_tf32=False,
                                cudnn_deterministic=True,
                                cudnn_benchmark=False, deterministic=True,
                                warn_only=True)),
    ("x64", dict(default_dtype=torch.float64)),
])
def test_apply_sets_its_switches_and_nothing_else(name, want):
    """From every switch set the other way: the preset's switches take its
    values, the rest keep theirs, and it becomes the active preset."""
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = True
    torch.use_deterministic_algorithms(False)
    before = _switches()
    assert before == dict(TF32_ON, **DET_OFF, default_dtype=torch.float32)
    got = pf.apply(name)
    assert got is pf.PRESETS[name] and pf.active() is got
    assert _switches() == dict(before, **want)
    if name == "x64":
        assert torch.zeros(2).dtype == torch.float64


def test_preset_object_applies_and_snapshot_restores():
    before = pf.snapshot()
    pf.apply(pf.PRESETS["fp32-deterministic"])
    assert pf.active().name == "fp32-deterministic"
    assert torch.are_deterministic_algorithms_enabled()
    pf.restore(before)
    assert pf.snapshot() == before


def test_from_args_round_trips():
    ap = argparse.ArgumentParser()
    pf.add_args(ap)
    assert pf.from_args(ap.parse_args([])) is None
    args = ap.parse_args(["--platform-preset", "fp32"])
    assert args.platform_preset == "fp32"
    assert pf.from_args(args) is pf.PRESETS["fp32"] is pf.active()
    with pytest.raises(SystemExit):
        ap.parse_args(["--platform-preset", "overlap"])


def test_provenance_stamps_the_preset():
    pf.restore(dict(pf.snapshot(), active=None))
    assert RunProvenance.collect("cpu").platform_preset is None
    pf.apply("deterministic")
    stamp = RunProvenance.collect("cpu").asdict()
    assert stamp["platform_preset"] == "deterministic"
    assert stamp["tf32_matmul"] == torch.backends.cuda.matmul.allow_tf32


def test_launchers_take_the_preset(tmp_path, capsys):
    """``--platform-preset`` on `launch.train`, `launch.serve` and the
    simulator example: applied before the run, so the metrics snapshot's
    provenance carries it."""
    import json

    from repro_torch.launch import serve, train
    from test_torch_examples import load
    torch_sim_stragglers = load("torch_sim_stragglers")
    runs = {
        "train": lambda m: train.main([
            "--smoke", "--device", "cpu", "--mode", "local", "--steps", "1",
            "--batch", "1", "--seq", "8", "--platform-preset", "fp32",
            "--metrics", m]),
        "serve": lambda m: serve.main([
            "--smoke", "--device", "cpu", "--batch", "1", "--prompt-len",
            "4", "--gen", "2", "--platform-preset", "fp32", "--metrics", m]),
        "sim": lambda m: torch_sim_stragglers.main([
            "--fast", "--rounds", "1", "--chunk", "1", "--device", "cpu",
            "--platform-preset", "fp32", "--metrics", m]),
    }
    for name, run in runs.items():
        pf.restore(dict(pf.snapshot(), active=None, matmul_tf32=True))
        path = tmp_path / f"{name}.json"
        run(str(path))
        assert pf.active().name == "fp32", name
        assert not torch.backends.cuda.matmul.allow_tf32, name
        stamp = json.loads(path.read_text())["provenance"]
        assert stamp["platform_preset"] == "fp32", name
    capsys.readouterr()
