"""The port's multi-device rules (`repro_torch.launch.sharding`,
`repro_torch.launch.mesh`, `repro_torch.models.shardctx`) against the
reference's `repro.launch.sharding` and `repro.launch.mesh`, without a
process group: meshes are stand-ins with the reference's ``axis_names``
and ``devices.shape``.

``param_specs`` of all ten full-width configs, leaf for leaf, on the
multi-pod production mesh (2, 16, 16) with the client axis on "pod", the
single-pod mesh (16, 16) and the two-client mesh (2, 1, 1); the reference
walks ``jax.eval_shape`` trees, the port the shapes ``model_init`` makes
under ``FakeTensorMode``.  ``cache_specs`` and ``batch_specs`` on the smoke
configs' decode caches and batches; the mesh shapes of every world size
1-8 against the reference's functions with its device count patched;
DTensor placements and a rank's slice; ``constrain`` the identity outside
a context and on plain tensors."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jget_config
from repro.launch import mesh as jmesh
from repro.launch import sharding as JS
from repro.models import api as japi
from repro_torch.configs import get_config, list_archs
from repro_torch.core.llm_algorithms import LLMDSFLAlgorithm
from repro_torch.core.llm_dsfl import LLMDsflHP
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as TS
from repro_torch.launch.collectives import pod_group
from repro_torch.models import api as tapi
from repro_torch.models import shardctx

from test_torch_convert import one_intra_op_thread  # noqa: F401

MESHES = {"multi_pod": ((2, 16, 16), ("pod", "data", "model"), "pod"),
          "single_pod": ((16, 16), ("data", "model"), None),
          "clients": ((2, 1, 1), ("pod", "data", "model"), "pod")}
N_CLIENTS = 2


def stand_in(shape, names):
    """A mesh as the rules read it: axis names and a device array shape."""
    return SimpleNamespace(axis_names=tuple(names), devices=np.empty(shape))


def flat_specs(tree) -> dict:
    """A reference spec tree as {"a/b": tuple(PartitionSpec)}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JS.P))[0]
    return {"/".join(str(p.key) for p in path): tuple(spec)
            for path, spec in leaves}


@pytest.fixture(scope="module")
def full_shapes():
    """Each arch's full-width parameter shapes: the reference's abstract
    init and the port's under fake tensors."""
    out = {}
    for arch in list_archs():
        ref = jax.eval_shape(lambda k: japi.model_init(jget_config(arch), k),
                             jax.random.PRNGKey(0))
        with FakeTensorMode():
            own = tapi.model_init(get_config(arch), torch.Generator(), "cpu")
            port = {k: tuple(v.shape) for k, v in own.items()}
        out[arch] = ref, port
    return out


def _stacked(ref, port, K):
    """The client-stacked forms: leaves with a leading (K,) axis."""
    ref = jax.tree.map(lambda a: jax.ShapeDtypeStruct((K,) + a.shape,
                                                      a.dtype), ref)
    return ref, {k: SimpleNamespace(shape=(K,) + s) for k, s in port.items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(full_shapes, arch, mesh_name):
    shape, names, client_axis = MESHES[mesh_name]
    mesh = stand_in(shape, names)
    ref, port = full_shapes[arch]
    port = {k: SimpleNamespace(shape=s) for k, s in port.items()}
    if client_axis is not None:
        ref, port = _stacked(ref, {k: v.shape for k, v in port.items()},
                             N_CLIENTS)
    want = flat_specs(JS.param_specs(jget_config(arch), ref, mesh,
                                     client_axis=client_axis))
    got = TS.param_specs(get_config(arch), port, mesh,
                         client_axis=client_axis)
    assert got == want
    assert all(len(sp) == len(port[k].shape) for k, sp in got.items())


def test_param_specs_shard_something():
    """The comparison has teeth: on the production mesh qwen1.5-4b's FFN
    is split over "model" and its embedding over both axes, and its
    attention (20 heads over 16) stays head-replicated."""
    cfg = get_config("qwen1.5-4b")
    mesh = stand_in((16, 16), ("data", "model"))
    shapes = {"embed/tok": (cfg.vocab, cfg.d_model),
              "blocks/s0_ffn/w_up": (40, cfg.d_model, cfg.d_ff),
              "blocks/s0_mix/wq": (40, cfg.d_model, cfg.d_model)}
    got = TS.param_specs(cfg, {k: SimpleNamespace(shape=s)
                               for k, s in shapes.items()}, mesh)
    assert got == {"embed/tok": ("model", "data"),
                   "blocks/s0_ffn/w_up": (None, "data", "model"),
                   "blocks/s0_mix/wq": (None, "data", None)}


def _smoke_batch(cfg, B, S):
    batch = {"tokens": np.zeros((B, S), np.int32)}
    if cfg.arch_type == "audio":
        batch["frames"] = np.zeros((B, cfg.n_audio_frames, cfg.d_model),
                                   np.float32)
    return batch


@pytest.mark.parametrize("mesh_name", ["single_pod", "clients"])
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(arch, mesh_name):
    shape, names, _ = MESHES[mesh_name]
    mesh = stand_in(shape, names)
    B, S = 4, 64
    jcfg, cfg = jget_config(arch).smoke(), get_config(arch).smoke()
    batch = _smoke_batch(cfg, B, S)
    jp = jax.eval_shape(lambda k: japi.model_init(jcfg, k),
                        jax.random.PRNGKey(0))
    jcache = jax.eval_shape(
        lambda p, b: japi.model_init_cache(jcfg, p, B, S, b), jp,
        {k: jnp.asarray(v) for k, v in batch.items()})
    params = tapi.model_init(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = tapi.model_init_cache(
        cfg, params, B, S, {k: torch.from_numpy(v) for k, v in batch.items()})
    cache = {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}
    want = flat_specs(JS.cache_specs(jcfg, jcache, mesh, B))
    got = TS.cache_specs(cfg, cache, mesh, B)
    assert got == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_specs_match_reference(mesh_name):
    """A private stack (K, B, S), an open batch (B, S), a teacher (B, S,
    V) past 1,024 classes and a scalar, with and without the client axis,
    at batch sizes that do and do not divide the axes."""
    shape, names, client_axis = MESHES[mesh_name]
    mesh = stand_in(shape, names)
    for B in (1, 4, 32):
        tree = {"tokens": (B, 128), "teacher": (B, 128, 151936),
                "small": (B, 128, 16), "pos": ()}
        ref = {k: jax.ShapeDtypeStruct(s, jnp.float32)
               for k, s in tree.items()}
        port = {k: SimpleNamespace(shape=s) for k, s in tree.items()}
        assert (TS.batch_specs(port, mesh)
                == flat_specs(JS.batch_specs(ref, mesh)))
        if client_axis is not None:
            refk = {k: jax.ShapeDtypeStruct((2,) + s, jnp.float32)
                    for k, s in tree.items()}
            portk = {k: SimpleNamespace(shape=(2,) + s)
                     for k, s in tree.items()}
            assert (TS.batch_specs(portk, mesh, client_axis="pod")
                    == flat_specs(JS.batch_specs(refk, mesh,
                                                 client_axis="pod")))


@pytest.mark.parametrize("world", range(1, 9))
def test_mesh_shapes_match_reference(world, monkeypatch):
    """`client_mesh_shape` for K 1-4 clients and the smoke meshes, against
    the reference's functions on a world of ``world`` devices."""
    monkeypatch.setattr(jmesh.jax, "devices", lambda: list(range(world)))
    monkeypatch.setattr(jmesh, "_mk", lambda shape, axes: (tuple(shape),
                                                           tuple(axes)))
    for K in range(1, 5):
        assert (tmesh.client_mesh_shape(world, K), tmesh.POD_AXES) \
            == jmesh.make_client_mesh(K)
    for multi in (False, True):
        names = tmesh.POD_AXES if multi else tmesh.DATA_MODEL_AXES
        assert (tmesh.smoke_mesh_shape(world, multi_pod=multi), names) \
            == jmesh.make_smoke_mesh(multi_pod=multi)
        assert (tmesh.production_mesh_shape(multi_pod=multi), names) \
            == jmesh.make_production_mesh(multi_pod=multi)
    assert tmesh.client_mesh_shape(1, 2) == (1, 1, 1)


def test_making_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no torch.distributed"):
        tmesh.make_client_mesh(2, device="cpu")


def test_placements_and_rank_slices():
    """`to_placements` names a Shard per sharded mesh axis; `local_slice`
    cuts each rank's part, and the parts tile the leaf in rank order."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = stand_in((2, 2, 2), ("pod", "data", "model"))
    assert TS.to_placements(mesh, ("pod", None, ("data", "model"))) == [
        Shard(0), Shard(2), Shard(2)]
    assert TS.to_placements(mesh, (None, "model")) == [
        Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="out of the mesh's order"):
        TS.to_placements(mesh, (("model", "data"),))
    x = torch.arange(2 * 3 * 8).reshape(2, 3, 8)
    spec = ("pod", None, ("data", "model"))
    parts = [TS.local_slice(x, spec, mesh, r) for r in range(8)]
    for r, part in enumerate(parts):
        c = TS.mesh_coords(mesh, r)
        j = c["data"] * 2 + c["model"]
        assert torch.equal(part, x[c["pod"]:c["pod"] + 1, :, 2 * j:2 * j + 2])
    with pytest.raises(ValueError, match="does not split"):
        TS.local_slice(torch.zeros(3, 4), ("pod",), mesh, 0)


@pytest.mark.parametrize("with_ctx", [False, True])
def test_constrain_is_identity_on_plain_tensors(with_ctx):
    x = torch.arange(24.0).reshape(2, 3, 4)
    mesh = stand_in((2, 4, 4), ("pod", "data", "model"))
    if with_ctx:
        with shardctx.axis_ctx(mesh, batch_axes=("pod", "data")):
            assert shardctx.constrain(x, "batch", None, "model") is x
            # what a DTensor would be asked for: batch 2 does not divide 8
            assert shardctx.spec_of((8, 3, 4), "batch", None, "model") == (
                ("pod", "data"), None, "model")
            assert shardctx.spec_of(x.shape, "batch", None, "model") == (
                None, None, "model")
    else:
        assert shardctx.constrain(x, "batch", None, "model") is x


@pytest.mark.parametrize("sizes", [(2, 1), (1, 2)])
def test_data_or_model_axes_above_one_raise(sizes):
    """A mesh that splits "data" or "model" now builds the audio family's
    algorithm (on a fake world of the mesh's size: its plan splits
    whisper's heads and columns over "model", its leaves over "data";
    the execution is tests/test_torch_tp_modality.py's); a mesh without a
    "pod" axis is still refused for the clients."""
    from repro_torch.launch import dryrun
    cfg = get_config("whisper-small").smoke()
    try:
        mesh = dryrun.fake_world(device="cpu", shape=(1,) + sizes)
        algo = LLMDSFLAlgorithm(cfg, LLMDsflHP(), device="cpu", mesh=mesh)
        assert (algo.plan.data.size, algo.plan.model.size) == sizes
        assert algo.plan.attn_tp == (sizes[1] > 1)
        assert algo.plan.data_dims["enc/attn/wq"] == (
            0 if sizes[0] > 1 else None)
        assert algo.pod.size == 1
    finally:
        dryrun.close_world()
    with pytest.raises(ValueError, match="no 'pod' axis"):
        pod_group(stand_in(sizes, ("data", "model")))
