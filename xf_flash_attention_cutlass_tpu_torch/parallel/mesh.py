"""Device mesh construction over ``torch.distributed``.

The JAX package's mesh has the axes ("dp", "pp", "cp", "ep", "tp"), tp the
fastest-varying, so that tensor-parallel collectives join neighbouring
devices. ``make_mesh`` builds the same axes as a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, which the caller initialises first, one process per rank:

    torch.distributed.init_process_group("cpu:gloo,cuda:nccl", ...)
    mesh = make_mesh(dp=2, tp=2)            # world size 4

Each axis of the mesh is a process group (``mesh.get_group("tp")``). The
serving engine exchanges its data-parallel results on host tensors, so a
default group with a CPU backend beside NCCL (``"cpu:gloo,cuda:nccl"``)
serves every mesh; the CPU tests run gloo alone.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("dp", "pp", "cp", "ep", "tp")
DP, PP, CP, EP, TP = AXES


def make_mesh(dp: int = 1, tp: int = 1, cp: int = 1, pp: int = 1, ep: int = 1,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A mesh with axes (dp, pp, cp, ep, tp), tp the fastest-varying, over
    the default process group, on `device_type` ("cuda" unless the caller
    names "cpu"). Raises when the default group is not initialised or its
    world size is not the product of the axes."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call torch.distributed.init_process_group first")
    n = dp * tp * cp * pp * ep
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"make_mesh: dp*pp*cp*ep*tp = {n}, but the world size is {world}")
    return init_device_mesh(device_type or "cuda", (dp, pp, cp, ep, tp), mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis`."""
    return mesh.get_local_rank(axis)
