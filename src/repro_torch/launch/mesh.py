"""Mesh construction: the port of `repro/launch/mesh.py`.

A PyTorch mesh is a `DeviceMesh` over the ranks of a process group, one
process per rank (multi-controller SPMD): every rank runs the same program
on its own device and its share of the data, and a collective joins the
ranks of one mesh axis.  Where the JAX package's one controller places
arrays with shardings, here each rank computes its block and the
collectives of `distributed/shardings.py` assemble what is replicated.

Functions, not module constants: importing this module touches no device
and no process group.

The backend (`backend_for`, `init_ranks`): NCCL when every rank has a card
of its own; gloo when ranks share a card (NCCL refuses two ranks on one
device) or run on the CPU.  Several ranks on one H100 is how the mesh
paths run on a one-card machine: each rank launches its own kernels on the
card, and gloo runs the collectives between them by way of the host.
"""
from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

__all__ = ["backend_for", "init_ranks", "init_ranks_from_env",
           "compat_mesh", "make_production_mesh", "make_test_mesh",
           "axis_sizes"]


def backend_for(device_type: str, world_size: int) -> str:
    """"nccl" when each of `world_size` ranks can have a card of its own,
    else "gloo" (the CPU, or ranks sharing a card)."""
    if device_type != "cuda":
        return "gloo"
    return "nccl" if world_size <= torch.cuda.device_count() else "gloo"


def init_ranks(rank: int, world_size: int, init_method: str,
               device_type: str = "cuda", timeout_s: float = 300.0) -> str:
    """Join this process to the process group as `rank` of `world_size`
    (`init_method` e.g. "tcp://localhost:<port>"): on "cuda" the rank's
    card is `rank % device_count`, set before the group exists.  Returns
    the backend it chose (`backend_for`).  A collective that waits longer
    than `timeout_s` raises instead of hanging the run."""
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    backend = backend_for(device_type, world_size)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return backend


def init_ranks_from_env(device_type: str = "cuda") -> str:
    """`init_ranks` from the variables `torchrun` sets (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT), unless the process group exists already
    (then its backend).  A variable that is missing raises KeyError."""
    if dist.is_initialized():
        return dist.get_backend()
    import os
    env = os.environ
    return init_ranks(int(env["RANK"]), int(env["WORLD_SIZE"]),
                      f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                      device_type)


def compat_mesh(shape, axes, device_type: str = "cuda"):
    """`init_device_mesh` of `shape` named `axes` over the process group
    already initialized (`init_ranks`).  Raises torch's own error when the
    world is smaller than the mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(launch.mesh.init_ranks)")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks; `pod` carries the cross-pod data
    parallelism (the compressed gradient all-reduce)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cuda"):
    """A small mesh for tests (needs as many ranks)."""
    return compat_mesh(shape, axes, device_type)


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh`, or of any object with a `shape`
    dict (the JAX package's `Mesh.shape`, the tests' fake meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)
