"""Production meshes over ``torch.distributed`` (port of
``repro.launch.mesh``).

Single pod: 16x16 = 256 ranks ('data', 'model').  Multi-pod: 2 pods of
256 = 512 ranks ('pod', 'data', 'model'); the 'pod' axis carries only data
parallelism, 'model' stays inside a pod.  A mesh is a ``DeviceMesh`` over
the default process group, which must already be initialised with that
many ranks: the fake backend in the LM dry run (``launch.dryrun``), real
ranks elsewhere.  With no group these raise; they never return "no
mesh".  The mesh's device type is CUDA when the group's backend is NCCL
and the CPU otherwise (gloo collectives and the fake backend's meta
tensors)."""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_axis_sizes",
           "make_mesh"]


def _world() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group is initialised: a mesh spans "
                           "the default group's ranks")
    return dist.get_world_size()


def make_mesh(shape: tuple, axes: tuple, device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    group, whose world size must equal ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    world = _world()
    if world != n:
        raise ValueError(f"mesh {shape} needs {n} ranks; the default group "
                         f"has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh(model: int = 1):
    """Every rank of the default group on ('data', 'model'), ``model`` of
    them along 'model'."""
    n = _world()
    if n % model:
        raise ValueError(f"model={model} does not divide {n} ranks")
    return make_mesh((n // model, model), ("data", "model"))


def mesh_axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
