"""Wire codecs (`repro_torch.core.wire`) against the reference's
`repro.core.wire`, and measured bytes (`FedEngine.measured_round_bytes`)
against `CommModel`'s analytic bytes for every DS-FL codec, FD and FedAvg
(mirroring tests/test_wire.py).

Tolerances: encodings of the same (80, 10) probabilities agree with the
reference's exactly in dtype, shape and bytes, in value to atol 1e-7
(fp32 arithmetic on identical inputs; int8 codes exactly); round trips
hold the reference's bounds (fp16 atol 5e-4, int8 half a step, top-k with
k = C 1e-6).  Measured bytes equal the analytic bytes exactly."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wire as jwire
from repro_torch.core import wire
from repro_torch.core.algorithms import (DSFLAlgorithm, FDAlgorithm, FDConfig,
                                         FedAvgAlgorithm, FedAvgConfig)
from repro_torch.core.comm import CommModel
from repro_torch.core.engine import FedEngine
from repro_torch.core.protocol import DSFLConfig
from repro_torch.models.smallnets import (apply_mnist_cnn, init_mnist_cnn,
                                          param_count)

from test_torch_convert import numpy_task
from test_torch_convert import one_intra_op_thread  # noqa: F401

K, N, C = 4, 80, 10
INIT = functools.partial(init_mnist_cnn, image_hw=16, widths=(8, 16), fc=32,
                         device="cpu")


@pytest.fixture(scope="module")
def probs():
    logits = np.random.default_rng(0).normal(size=(N, C)).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return torch.tensor(p), jnp.asarray(p)


@pytest.fixture(scope="module")
def task():
    return numpy_task(0, K, N, N, 40)[1]


@pytest.mark.parametrize("name,kw", [("dense_f32", {}), ("fp16", {}),
                                     ("topk", {"k": 3, "n_classes": C}),
                                     ("int8", {})])
def test_encoding_matches_reference(probs, name, kw):
    p, jp = probs
    enc = wire.make_codec(name, **kw).encode(p)
    jenc = jwire.make_codec(name, **kw).encode(jp)
    flat = enc if isinstance(enc, dict) else {"": enc}
    jflat = jenc if isinstance(jenc, dict) else {"": jenc}
    assert set(flat) == set(jflat)
    for k, v in flat.items():
        jv = np.asarray(jflat[k])
        assert v.numpy().dtype == jv.dtype and tuple(v.shape) == jv.shape, k
        np.testing.assert_allclose(v.numpy().astype(np.float64),
                                   jv.astype(np.float64), rtol=0, atol=1e-7)
    assert wire.nbytes(enc) == jwire.nbytes(jenc)


def test_dense_f32_roundtrip_exact(probs):
    codec = wire.DenseF32Codec()
    assert torch.equal(codec.decode(codec.encode(probs[0])), probs[0])


def test_fp16_roundtrip_within_half_precision(probs):
    codec = wire.FP16Codec()
    enc = codec.encode(probs[0])
    assert enc.dtype == torch.float16
    out = codec.decode(enc)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, probs[0], atol=5e-4, rtol=0)


def test_topk_roundtrips(probs):
    p = probs[0]
    full = wire.TopKCodec(k=C, n_classes=C)
    torch.testing.assert_close(full.decode(full.encode(p)), p, atol=1e-6,
                               rtol=0)
    out = wire.TopKCodec(k=3, n_classes=C).decode(
        wire.TopKCodec(k=3, n_classes=C).encode(p))
    torch.testing.assert_close(out.sum(-1), torch.ones(N), atol=1e-5, rtol=0)
    assert int((out[0] != 0).sum()) <= 3


def test_int8_roundtrip_within_half_step(probs):
    codec = wire.Int8Codec()
    enc = codec.encode(probs[0])
    assert enc["q"].dtype == torch.uint8
    out = codec.decode(enc)
    assert out.dtype == torch.float32
    half_step = float(enc["scale"]) / 2
    assert float((out - probs[0]).abs().max()) <= half_step * 1.001


def test_asymmetric_codec_legs(probs):
    p = probs[0]
    codec = wire.AsymmetricCodec(up=wire.TopKCodec(k=3, n_classes=C),
                                 down=wire.FP16Codec())
    up, down = codec.encode_up(p), codec.encode_down(p)
    assert codec.payload_bytes(up) == N * 3 * 8
    assert codec.payload_bytes(down) == N * C * 2
    assert torch.equal(up["v"], codec.encode(p)["v"])
    torch.testing.assert_close(codec.decode_down(down), p, atol=1e-3, rtol=0)
    assert int((codec.decode_up(up)[0] != 0).sum()) <= 3
    for sym in (wire.DenseF32Codec(), wire.FP16Codec(), wire.Int8Codec()):
        assert wire.nbytes(sym.encode_up(p)) == wire.nbytes(sym.encode_down(p))


def test_codecs_encode_whole_trees():
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(3, C, generator=g),
            "b": [torch.randn(2, 2, C, generator=g)]}
    out = wire.FP16Codec().decode(wire.FP16Codec().encode(tree))
    assert set(out) == {"a", "b"} and out["b"][0].dtype == torch.float32
    enc = wire.Int8Codec().encode(tree)
    assert wire.nbytes(enc) == 3 * C + 4 * C + 2 * 8     # + (scale, zero)s
    assert wire.measured_payload_bytes(wire.DenseF32Codec(), lambda t: t,
                                       tree) == 4 * 7 * C


def test_make_codec_registry():
    assert isinstance(wire.make_codec("dense_f32"), wire.DenseF32Codec)
    assert wire.make_codec("topk", k=7, n_classes=C).k == 7
    asym = wire.make_codec("asym", up=wire.Int8Codec())
    assert isinstance(asym.up, wire.Int8Codec)
    assert isinstance(asym.down, wire.FP16Codec)
    with pytest.raises(KeyError):
        wire.make_codec("zstd")


def _dsfl(task):
    hp = DSFLConfig(rounds=1, local_epochs=1, distill_epochs=1, batch_size=40,
                    open_batch=N)
    algo = DSFLAlgorithm(apply_mnist_cnn, hp, device="cpu")
    return algo, FedEngine(algo).init(INIT, task)


@pytest.mark.parametrize("codec,method", [
    (wire.DenseF32Codec(), "dsfl"), (wire.FP16Codec(), "dsfl_fp16"),
    (wire.TopKCodec(k=5, n_classes=C), "dsfl_topk"),
    (wire.Int8Codec(), "dsfl_int8")])
def test_measured_equals_analytic_for_every_dsfl_codec(task, codec, method):
    algo, state = _dsfl(task)
    assert FedEngine(algo, codec=codec).measured_round_bytes(state, task) == \
        CommModel(K, C, 0, N).round_bytes(method, topk=5)


def test_measured_leg_bytes_asymmetric(task):
    algo, state = _dsfl(task)
    cm = CommModel(K, C, 0, N)
    eng = FedEngine(algo, codec=wire.AsymmetricCodec(
        up=wire.TopKCodec(k=5, n_classes=C), down=wire.FP16Codec()))
    up, down = eng.measured_leg_bytes(state, task)
    assert up == cm.dsfl_topk_round(5) // (K + 1)
    assert down == cm.dsfl_fp16_round() // (K + 1)
    assert eng.measured_round_bytes(state, task) == up * K + down


@pytest.mark.parametrize("kind", ["fd", "fedavg"])
def test_measured_equals_analytic_baselines(task, kind):
    if kind == "fd":
        algo = FDAlgorithm(apply_mnist_cnn, FDConfig(rounds=1, n_classes=C),
                           device="cpu")
        state = FedEngine(algo).init(INIT, task)
        want = CommModel(K, C, 0, N).fd_round()
    else:
        algo = FedAvgAlgorithm(apply_mnist_cnn, FedAvgConfig(rounds=1),
                               device="cpu")
        state = FedEngine(algo).init(INIT, task)
        n = param_count(state.server.params, state.server.model_state)
        want = CommModel(K, C, n, N).fl_round()
    assert FedEngine(algo).measured_round_bytes(state, task) == want
