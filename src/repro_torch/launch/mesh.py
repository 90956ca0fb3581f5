"""Device meshes over `torch.distributed`.

Kept as functions (never module-level constants) so importing this module
starts no process group.  `make_host_mesh` is what this host has: a
``("data", "model")`` `DeviceMesh` over the process group, formed first if
there is none (NCCL on the card, gloo on the CPU).  The rendezvous is local
only: the environment's ``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` /
``WORLD_SIZE`` when a launcher set them, else a one-rank world on an
in-process store.  `make_production_mesh` needs a world of 256 (512)
ranks; a `distributed.sharding.MeshShape` of the same names and sizes is
what the sharding rules and the cost model price on one host.
`make_fake_mesh` is the production mesh on one host for tracing: a
`DeviceMesh` over a fake process group (this process is rank 0), whose
collectives send nothing; the launch tools trace fake tensors on it.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device


def ensure_process_group(device: torch.device,
                         init_method: str | None = None) -> None:
    """Form the default process group for `device` if there is none:
    NCCL for ``cuda``, gloo for ``cpu``.  An existing group must have that
    backend (the card never falls back to gloo)."""
    want = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise RuntimeError(f"process group is {have!r}, a {device.type} "
                               f"mesh needs {want!r}")
        return
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    kwargs = {}
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", str(rank)))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
    if init_method is None and world == 1 and "MASTER_ADDR" not in os.environ:
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = init_method or "env://"
    dist.init_process_group(want, rank=rank, world_size=world, **kwargs)


def make_host_mesh(model: int = 1, device=None, init_method: str | None = None):
    """Whatever this world has: a (world // model, model) ``("data",
    "model")`` `DeviceMesh` on `device` (the card unless told
    otherwise)."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    ensure_process_group(dev, init_method)
    n = dist.get_world_size()
    if n % model:
        raise ValueError(f"model={model} does not divide world {n}")
    return init_device_mesh(dev.type, (max(n // model, 1), model),
                            mesh_dim_names=("data", "model"))


def production_dims(multi_pod: bool = False):
    """(sizes, names) of the production mesh: 16x16 = 256 chips per pod,
    (2, 16, 16) = 512 multi-pod."""
    return (((2, 16, 16), ("pod", "data", "model")) if multi_pod
            else ((16, 16), ("data", "model")))


def make_fake_mesh(dims: tuple[int, ...], names: tuple[str, ...],
                   device=None):
    """A `DeviceMesh` of `dims` over a fake process group of prod(dims)
    ranks, formed here as rank 0 (an earlier fake group of another size is
    replaced; a real group raises).  Meant for fake tensors
    (`FakeTensorMode`): its collectives move nothing."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    need = 1
    for d in dims:
        need *= d
    dev = resolve_device(device)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(f"a {dist.get_backend()!r} process group is "
                               f"formed; a fake mesh needs its own process")
        if dist.get_world_size() != need:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=need)
    return init_device_mesh(dev.type, tuple(dims), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device=None,
                         init_method: str | None = None):
    """The production `DeviceMesh`, 16x16 = 256 chips per pod, (2, 16,
    16) = 512 multi-pod; raises unless the world has exactly that many
    ranks.  ``sharding.MeshShape(dims, names)`` is the same mesh as names
    and sizes, for pricing it on one host."""
    from torch.distributed.device_mesh import init_device_mesh
    dims, names = production_dims(multi_pod)
    need = 1
    for d in dims:
        need *= d
    dev = resolve_device(device)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world != need:
        raise ValueError(f"the production mesh {dims} needs {need} ranks, "
                         f"this world has {world}")
    ensure_process_group(dev, init_method)
    return init_device_mesh(dev.type, dims, mesh_dim_names=names)
