"""Meshes over the ``torch.distributed`` world (mirrors
``repro/launch/mesh.py``).  Functions, not module-level constants:
importing this module touches no process group.

Each mesh is a ``DeviceMesh`` with the reference's axis names and shapes,
made by ``init_device_mesh`` over the initialized world (`launch.dist`
starts it).  The shapes themselves are pure functions of the world size
(`client_mesh_shape` and friends), so they are testable without a group;
`axis_sizes` reads the axis sizes of a ``DeviceMesh`` or of any stand-in
with ``axis_names`` and ``devices.shape`` (the reference's ``Mesh``
attributes) or ``shape``.
"""
from __future__ import annotations

from ..device import resolve_device

POD_AXES = ("pod", "data", "model")
DATA_MODEL_AXES = ("data", "model")


def client_mesh_shape(world: int, n_clients: int) -> tuple[int, int, int]:
    """The reference's client mesh: the federated-client axis on "pod"
    when the world holds a multiple of the clients, else every rank on
    "model" (one rank gives (1, 1, 1))."""
    pod = n_clients if world >= n_clients and world % n_clients == 0 else 1
    return (pod, 1, world // pod)


def production_mesh_shape(*, multi_pod: bool = False) -> tuple[int, ...]:
    """Single pod 16 x 16 = 256 ranks; multi-pod 2 x 16 x 16 = 512, whose
    leading "pod" axis is the DS-FL federated-client axis."""
    return (2, 16, 16) if multi_pod else (16, 16)


def smoke_mesh_shape(world: int, *, multi_pod: bool = False
                     ) -> tuple[int, ...]:
    """The same axis names over however many ranks exist."""
    return (1, 1, world) if multi_pod else (1, world)


def _world() -> int:
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError(
            "no torch.distributed process group: start one first "
            "(launch.dist.init_rank, or torchrun with init_from_env)")
    return dist.get_world_size()


def _mk(shape, axes, device):
    from torch.distributed.device_mesh import init_device_mesh
    _world()
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    return _mk(production_mesh_shape(multi_pod=multi_pod),
               POD_AXES if multi_pod else DATA_MODEL_AXES, device)


def make_mesh(shape, device="cuda"):
    """("pod", "data", "model") of the given shape over the world (its
    product must be the world size)."""
    return _mk(tuple(shape), POD_AXES, device)


def make_client_mesh(n_clients: int, device="cuda"):
    """("pod", "data", "model") over the world, the clients on "pod" when
    the world size divides by them (`client_mesh_shape`)."""
    return _mk(client_mesh_shape(_world(), n_clients), POD_AXES, device)


def make_smoke_mesh(*, multi_pod: bool = False, device="cuda"):
    return _mk(smoke_mesh_shape(_world(), multi_pod=multi_pod),
               POD_AXES if multi_pod else DATA_MODEL_AXES, device)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or a stand-in mesh."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    devices = getattr(mesh, "devices", None)
    shape = devices.shape if devices is not None else mesh.shape
    return dict(zip(names, tuple(shape)))


def axis_size(mesh, name: str) -> int:
    """Size of axis ``name`` (1 when the mesh has no such axis)."""
    return axis_sizes(mesh).get(name, 1)
