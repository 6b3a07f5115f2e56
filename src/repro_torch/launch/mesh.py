"""Production and host meshes over the default process group.

Counterpart of :mod:`repro.launch.mesh`: ``repro`` lays its 256 or 512
devices out as a ``jax.make_mesh``; here a mesh is a
:class:`~torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, one rank a device.  Functions, not constants:
importing this module touches no process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

PROD_SHAPES = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def _device_type(device) -> str:
    if device is not None:
        return torch.device(device).type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def check_production_world(multi_pod: bool = False) -> None:
    """Raise ``ValueError`` unless the default process group has the
    production mesh's 256 (512 with ``multi_pod``) ranks."""
    shape, _ = PROD_SHAPES[multi_pod]
    need = 1
    for s in shape:
        need *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"the production mesh {'x'.join(map(str, shape))} needs a "
            f"process group of {need} ranks (e.g. torchrun --nnodes ... "
            f"--nproc-per-node ...), got a world size of {world}")


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 ``("data", "model")`` (256 ranks) or 2x16x16 ``("pod",
    "data", "model")`` (512 ranks) over the default process group.

    ``device``: the ranks' device type (default: ``cuda`` on an NCCL
    group, else ``cpu``).

    Raises:
      ValueError: no process group, or its world size is not the mesh's.
    """
    check_production_world(multi_pod)
    shape, names = PROD_SHAPES[multi_pod]
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=names)


def make_host_mesh(shape: tuple[int, ...] | None = None, *, device=None):
    """The default group's ranks as a 1-D ``("data",)`` mesh, or, given
    ``shape = (data, model)``, as a ``("data", "model")`` mesh.

    Raises:
      ValueError: ``shape`` does not multiply to the world size.
    """
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if shape is None:
        shape, names = (world,), ("data",)
    else:
        shape, names = tuple(shape), ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a host mesh of shape {shape} needs {n} ranks, "
                         f"the world size is {world}")
    return init_device_mesh(_device_type(device), shape,
                            mesh_dim_names=names)
