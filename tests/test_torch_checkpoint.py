"""Checkpoints (`repro_torch.checkpoint`, `FedEngine.save_state` /
``load_state``) against the reference's msgpack files: the port's encoder
emits ``msgpack.packb(_pack(tree), use_bin_type=True)`` byte for byte, each
package reads the other's files, and a file that does not fit the state
raises, naming the leaf."""
import mmap
import os

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as j_load
from repro.checkpoint import save_pytree as j_save
from repro.checkpoint.msgpack_ckpt import _pack as j_pack
from repro.core.algorithms import DSFLAlgorithm as JAlgo
from repro.core.engine import FedEngine as JEngine
from repro.core.protocol import DSFLConfig as JConfig
from repro.models.smallnets import apply_tiny_mlp as j_apply
from repro.models.smallnets import init_tiny_mlp as j_init
from repro_torch import convert
from repro_torch.checkpoint import (assert_tree_compatible, load_pytree,
                                    named_leaves, save_pytree,
                                    tree_mismatches, with_leaves)
from repro_torch.checkpoint import msgpack_ckpt as ck
from repro_torch.core.algorithms import DSFLAlgorithm
from repro_torch.core.engine import FedEngine
from repro_torch.core.protocol import DSFLConfig
from repro_torch.models.smallnets import apply_tiny_mlp, init_tiny_mlp

from test_torch_convert import assert_state_close, numpy_task
from test_torch_convert import one_intra_op_thread  # noqa: F401

HP = dict(rounds=1, local_epochs=1, distill_epochs=1, batch_size=20,
          open_batch=40)


def _leaves():
    """One leaf of each kind: (port tensor, reference numpy array)."""
    import ml_dtypes
    bf = np.array([[1.0, -2.5], [3.140625, 65280.0]], np.float32)
    return {
        "f32": (torch.arange(6, dtype=torch.float32).reshape(2, 3) - 2.5,
                (np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5)),
        "bf16": (torch.tensor(bf).to(torch.bfloat16),
                 bf.astype(ml_dtypes.bfloat16)),
        "i64": (torch.tensor([-(2 ** 31), 7, 2 ** 31 - 1]),
                np.array([-(2 ** 31), 7, 2 ** 31 - 1], np.int64)),
        "bool": (torch.tensor([True, False, True]),
                 np.array([True, False, True])),
        "empty": (torch.zeros((0, 3)), np.zeros((0, 3), np.float32)),
        "scalar": (torch.tensor(5, dtype=torch.int64), np.int64(5)),
    }


@pytest.mark.parametrize("kind", ["f32", "bf16", "i64", "bool", "empty",
                                  "scalar"])
def test_encoder_bytes_equal_msgpack(kind):
    port, ref = _leaves()[kind]
    tree_p = {"a": port, "seq": [port, (port,)], "nested": {"x": port}}
    tree_r = {"a": ref, "seq": [ref, (ref,)], "nested": {"x": ref}}
    want = msgpack.packb(j_pack(tree_r), use_bin_type=True)
    assert ck.packb(ck._pack(tree_p)) == want
    back = ck._unpack(ck.unpackb(bytearray(want)))
    assert back["a"].dtype == port.dtype and torch.equal(back["a"], port)
    assert isinstance(back["seq"][1], tuple)


@pytest.mark.parametrize("x", [0, 1, 127, 128, 255, 256, 65535, 65536,
                               2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1, -1, -32,
                               -33, -128, -129, -32768, -32769, -2 ** 31,
                               -2 ** 31 - 1, -2 ** 63, 1.5, -0.0, None, True,
                               False, "", "a" * 31, "b" * 32, "c" * 300,
                               "d" * 70000, b"", b"x" * 300, b"y" * 70000])
def test_scalar_and_header_encodings(x):
    """Every int width, fix and 8/16/32-bit str and bin headers, floats,
    nil and bools as msgpack-python writes them, and read back."""
    want = msgpack.packb(x, use_bin_type=True)
    assert ck.packb(x) == want
    got = ck.unpackb(bytearray(want))
    assert (bytes(got) if isinstance(x, bytes) else got) == x


def test_containers_past_fix_sizes_and_bad_input():
    obj = {"m": {str(i): i for i in range(20)}, "a": list(range(20))}
    want = msgpack.packb(obj, use_bin_type=True)
    assert ck.packb(obj) == want and ck.unpackb(bytearray(want)) == obj
    with pytest.raises(ValueError, match="truncated"):
        ck.unpackb(bytearray(want[:-3]))
    with pytest.raises(ValueError, match="after the msgpack"):
        ck.unpackb(bytearray(want + b"\xc0"))
    with pytest.raises(ValueError, match="outside the subset"):
        ck.unpackb(bytearray(b"\xc7\x01\x00\x00"))      # ext 8


def test_leaf_above_4_gib_raises(tmp_path):
    """A bin blob holds at most 4 GiB: a larger leaf raises instead of
    being cut (a sparse file stands in for the 4 GiB + 1 bytes)."""
    path = tmp_path / "big"
    with open(path, "wb") as f:
        f.truncate(2 ** 32 + 1)
    with open(path, "rb") as f, \
            mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        view = memoryview(mm)
        try:
            with pytest.raises(ValueError, match="4 GiB"):
                ck.encode(view, [])
        finally:
            view.release()


def test_files_cross_both_ways(tmp_path):
    """The reference reads the port's file, the port the reference's; the
    port writes through a temporary file and a rename."""
    leaves = _leaves()
    tree_p = {"leaves": [v[0] for v in leaves.values()], "n": torch.tensor(3),
              "round": np.int64(4), "tag": np.frombuffer(b"dsfl", np.uint8)}
    tree_r = {"leaves": [v[1] for v in leaves.values()], "n": np.int64(3),
              "round": np.int64(4), "tag": np.frombuffer(b"dsfl", np.uint8)}
    pp, pr = str(tmp_path / "port.ckpt"), str(tmp_path / "ref.ckpt")
    save_pytree(pp, tree_p)
    assert not os.path.exists(pp + ".tmp")
    j_save(pr, tree_r)
    with open(pp, "rb") as a, open(pr, "rb") as b:
        assert a.read() == b.read()
    for got in (j_load(pp), j_load(pr)):
        for x, (_, ref) in zip(got["leaves"], leaves.values()):
            np.testing.assert_array_equal(
                np.asarray(x).astype(np.float32) if ref.dtype.name ==
                "bfloat16" else np.asarray(x), ref.astype(np.float32)
                if ref.dtype.name == "bfloat16" else ref)
    got = load_pytree(pr)
    for x, (port, _) in zip(got["leaves"], leaves.values()):
        assert x.dtype == port.dtype and torch.equal(x, port)


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    """The reference engine after one round (K=4, tiny_mlp), saved."""
    ref_task, port_task = numpy_task(2, 4, 40, 80, 40)
    jalgo = JAlgo(j_apply, JConfig(**HP))
    jeng = JEngine(jalgo, lambda w, s: {"test_acc": 0.5})
    jstate = jeng.run(jeng.init(j_init, ref_task), ref_task, rounds=1)
    path = str(tmp_path_factory.mktemp("ref") / "engine.ckpt")
    jeng.save_state(path, jstate)
    return path, jax.device_get(jstate), jeng, port_task


def test_port_loads_the_reference_engines_file(reference_checkpoint):
    path, jstate, jeng, task = reference_checkpoint
    algo = DSFLAlgorithm(apply_tiny_mlp, DSFLConfig(**HP), device="cpu")
    eng = FedEngine(algo)
    like = eng.init(lambda g: init_tiny_mlp(g, device="cpu"), task)
    state = eng.load_state(path, like)
    assert_state_close(state, jstate, atol=0.0)
    want = convert.round_state_from_numpy(jstate, "cpu")
    for (n, a), (_, b) in zip(named_leaves(state), named_leaves(want)):
        assert torch.equal(a, b), n
    assert eng.rounds_done == jeng.rounds_done == 1
    assert eng.history == jeng.history
    # and the reference reads the port's file of the same state
    out = path + ".port"
    eng.save_state(out, state)
    jeng2 = JEngine(JAlgo(j_apply, JConfig(**HP)))
    back = jeng2.load_state(out, jstate)
    assert jeng2.rounds_done == 1 and jeng2.history == jeng.history
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_wrong_leaf_raises_naming_it(reference_checkpoint, tmp_path):
    path, _, _, task = reference_checkpoint
    algo = DSFLAlgorithm(apply_tiny_mlp, DSFLConfig(**HP), device="cpu")
    eng = FedEngine(algo)
    wide = eng.init(lambda g: init_tiny_mlp(g, hidden=16, device="cpu"), task)
    with pytest.raises(ValueError, match=r"server\.params\.d1/w: expected "
                                         r"\(256, 16\) float32, got "
                                         r"\(256, 32\) float32"):
        eng.load_state(path, wide)
    adam = FedEngine(DSFLAlgorithm(apply_tiny_mlp, DSFLConfig(
        **HP, optimizer="adam"), device="cpu"))
    like = adam.init(lambda g: init_tiny_mlp(g, device="cpu"), task)
    with pytest.raises(ValueError, match="leaves but the engine's state has"):
        adam.load_state(path, like)
    fd = FedEngine(type("FD", (), {"name": "fd", "device": "cpu"})())
    with pytest.raises(ValueError, match="checkpoint is for 'dsfl'"):
        fd.load_state(path, like)


def test_tree_helpers_name_leaves_in_the_reference_order():
    from repro_torch.core.algorithms import ClientState, RoundState
    params = {"c1/w": torch.zeros(2), "bn1/scale": torch.zeros(1),
              "c10/b": torch.zeros(3), "c1/b": torch.zeros(4)}
    st = RoundState(clients=ClientState(params=params))
    names = [n for n, _ in named_leaves(st)]
    assert names == ["clients.params.bn1/scale", "clients.params.c1/b",
                     "clients.params.c1/w", "clients.params.c10/b"]
    # jax walks the nested form of the same dict in the same order
    nested = convert.to_numpy_tree(params)
    assert [a.shape for a in jax.tree.leaves(nested)] == \
        [v.shape for _, v in named_leaves(st)]
    moved = with_leaves(st, [torch.ones(1), torch.ones(4), torch.ones(2),
                             torch.ones(3)])
    assert list(moved.clients.params) == list(params)
    assert tree_mismatches(st, moved) == []
    bad = with_leaves(st, [torch.ones(2), torch.ones(4), torch.ones(2),
                           torch.ones(3)])
    with pytest.raises(ValueError, match=r"bn1/scale: expected \(1,\)"):
        assert_tree_compatible(st, bad)
    assert "missing" in tree_mismatches(st, RoundState())[0]
