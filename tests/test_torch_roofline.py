"""The port's single-card roofline (`repro_torch.launch.roofline`): the
useful-FLOPs estimate equal to the reference's for every architecture and
input shape, the least time of a call reproducing the bounds of PERF.md's
kernel table (chip_smoke.py takes its bounds from it), and the
bottleneck `Roofline.from_terms` names."""
import pytest

import chip_smoke
from repro.configs import get_config as jget_config
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import roofline as jroofline
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.launch import roofline as rf

from test_torch_convert import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_estimate_equals_the_reference(arch):
    assert set(SHAPES) == set(JSHAPES)
    for name, shape in SHAPES.items():
        assert rf.model_flops_estimate(get_config(arch), shape) == \
            jroofline.model_flops_estimate(jget_config(arch), JSHAPES[name])


def test_scout_client_step_estimate():
    """The value chip_smoke.py's phase "moe train" prints beside its
    counted FLOPs: llama4-scout at 2 layers, one step of batch 8, seq
    128."""
    cfg = get_config("llama4-scout-17b-a16e").replace(n_layers=2)
    shape = InputShape("step", 128, 8, "train")
    assert rf.model_flops_estimate(cfg, shape) == 8_675_162_849_280.0


def _era_bytes(K, N, C, elt):
    return K * N * C * elt + N * C * 4


def _k34_bytes(N, V, elt, reads):
    return reads * N * V * elt + 2 * N * 4 + (4 if reads == 3 else 0)


@pytest.mark.parametrize("what,ms_by,want", [
    ("K1 (2, 1024, 151936) bf16",
     lambda: rf.bound_ms(_era_bytes(2, 1024, 151_936, 2), 7 * 1024 * 151_936),
     (0.37154, "bytes")),
    ("K3 (1024, 50280) bf16",
     lambda: rf.bound_ms(_k34_bytes(1024, 50_280, 2, 2), 6 * 1024 * 50_280),
     (0.06148, "bytes")),
    ("K4 (1024, 50280) bf16",
     lambda: rf.bound_ms(_k34_bytes(1024, 50_280, 2, 3), 5 * 1024 * 50_280),
     (0.09222, "bytes")),
    ("K5 (32, 256, 80, 64, 1, 128)",
     lambda: chip_smoke.k5_bound(32, 256, 80, 64, 1, 128)[:2],
     (0.10423, "bytes")),
    ("K1 (2, 1024, 202048) bf16",
     lambda: rf.bound_ms(_era_bytes(2, 1024, 202_048, 2), 7 * 1024 * 202_048),
     (0.49408, "bytes")),
])
def test_bound_ms_reproduces_the_kernel_table(what, ms_by, want):
    ms, by = ms_by()
    assert round(ms, 5) == want[0] and by == want[1], what


def test_bound_ms_picks_the_larger_term():
    assert rf.bound_ms(rf.HBM_BYTES_PER_S * 1e-3, 0) == (1.0, "bytes")
    ms, by = rf.bound_ms(0, rf.FP32_FLOPS * 2e-3)
    assert by == "operations" and ms == pytest.approx(2.0)
    # fp32 and TF32 units run side by side: the slower of the two counts
    ms, by = rf.bound_ms(0, rf.FP32_FLOPS * 1e-3, rf.TF32_FLOPS * 3e-3)
    assert by == "operations" and ms == pytest.approx(3.0)
    assert chip_smoke.bound_ms is rf.bound_ms
    assert chip_smoke.L2_BYTES == rf.L2_BYTES == 50 * 2 ** 20


@pytest.mark.parametrize("flops,nbytes,want", [
    (rf.BF16_FLOPS * 2e-3, rf.HBM_BYTES_PER_S * 1e-3, "compute"),
    (rf.BF16_FLOPS * 1e-3, rf.HBM_BYTES_PER_S * 2e-3, "memory"),
])
def test_from_terms_names_the_bottleneck(flops, nbytes, want):
    r = rf.Roofline.from_terms(arch="a", shape="s", step="train",
                               flops=flops, bytes_accessed=nbytes,
                               model_flops=flops / 2, peak_mem_bytes=7,
                               arg_bytes=3)
    assert r.bottleneck == want
    assert (r.t_collective, r.coll_bytes, r.coll_breakdown) == (0.0, 0.0, {})
    assert r.useful_ratio == 0.5
    assert r.to_dict()["peak_mem_bytes"] == 7.0
    assert r.t_compute == pytest.approx(flops / rf.BF16_FLOPS)
