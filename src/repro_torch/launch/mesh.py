"""Process groups and the ("data", "model") device mesh of the port.

The JAX package runs one controller over a ``jax.sharding.Mesh``; the port
runs SPMD: every rank is a process with one device, and a mesh is a
``torch.distributed`` ``DeviceMesh`` over those ranks.  NCCL carries the
collectives on the card, gloo on the CPU; a group never stages a tensor
through the host for the other device type.

:func:`init_distributed` joins the job ``torchrun`` started (its
``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` environment) or, without one, makes
a one-rank group in this process.  A caller that has already called
``torch.distributed.init_process_group`` (with its own store) keeps it.
"""
from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device


def local_device(device: DeviceLike = None) -> torch.device:
    """``resolve_device``, with a ``torchrun`` rank's default card being
    ``cuda:LOCAL_RANK`` (made the current device)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    dev = resolve_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(device: torch.device) -> bool:
    """Join or create the default process group for ``device``'s type;
    returns True when this call created it (the caller then destroys it)."""
    if dist.is_initialized():
        return False
    backend = backend_for(device)
    if "WORLD_SIZE" in os.environ:               # a torchrun job
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named device mesh and the device this rank runs on."""
    device_mesh: DeviceMesh
    device: torch.device

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> dict[str, int]:
        return {ax: self.device_mesh.size(i)
                for i, ax in enumerate(self.axis_names)}

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``; a rank's
        index in it is its coordinate on the axis."""
        return self.device_mesh.get_group(axis)


def device_mesh(shape: tuple[int, ...], names: tuple[str, ...],
                device: DeviceLike = None) -> Mesh:
    """A mesh of the given shape over every rank of the job (the product of
    ``shape`` must be the world size); joins or creates the job first."""
    dev = local_device(device)
    init_distributed(dev)
    world = dist.get_world_size()
    size = 1
    for s in shape:
        size *= s
    if size != world:
        raise ValueError(f"mesh {dict(zip(names, shape))} needs {size} "
                         f"ranks; the job has {world}")
    return Mesh(init_device_mesh(dev.type, tuple(shape),
                                 mesh_dim_names=tuple(names)), dev)


def make_mesh(model: int = 1, device: DeviceLike = None) -> Mesh:
    """The ("data", "model") mesh over every rank: p₂ = ``model`` ranks per
    tensor-parallel group, p₁ = world / p₂ data shards (cf. the JAX
    package's ``launch/mesh.make_host_mesh``)."""
    dev = local_device(device)
    init_distributed(dev)
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"--model-parallel {model} must divide the "
                         f"{world} ranks of the job")
    return device_mesh((world // model, model), ("data", "model"), dev)


def make_host_mesh(model: int = 1, device: DeviceLike = None) -> Mesh:
    """The mesh over whatever this job has, as the JAX package's
    ``launch/mesh.make_host_mesh`` builds it (``ClusterRuntime.mesh`` calls
    it): one data axis and the model axis.  The JAX package's multi-pod
    "pod" axis is folded into the data axis here; a mesh a caller builds
    with two data axes is refused by ``core/parallel``."""
    return make_mesh(model, device)
