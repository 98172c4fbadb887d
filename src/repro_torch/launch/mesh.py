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

:func:`make_production_mesh` builds the production meshes of the dry run
(16×16 and 2×16×16) over a fake process group in this process, the
counterpart of the JAX package's 512 placeholder CPU devices.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
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
    """A named device mesh and the device this rank runs on.  ``flat``
    holds the groups of several axes flattened into one (made with the
    mesh, on every rank: group creation is collective)."""
    device_mesh: DeviceMesh
    device: torch.device
    flat: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def shape(self) -> dict[str, int]:
        return {ax: self.device_mesh.size(i)
                for i, ax in enumerate(self.axis_names)}

    def group(self, axis):
        """The process group of this rank's line along ``axis``; a rank's
        index in it is its coordinate on the axis.  A tuple of axes (the
        data axes ("pod", "data")) names their flattened line, indexed in
        the order of the axes (pod-major), as ``jax.lax.axis_index`` of a
        tuple counts."""
        if isinstance(axis, str):
            return self.device_mesh.get_group(axis)
        axis = tuple(axis)
        if len(axis) == 1:
            return self.device_mesh.get_group(axis[0])
        if axis not in self.flat:
            raise ValueError(f"mesh {self.shape} has no flattened group of "
                             f"{axis} (made for its non-model axes "
                             f"{tuple(self.flat)})")
        return self.flat[axis]


def _flat_groups(shape: tuple[int, ...], names: tuple[str, ...],
                 axes: tuple[str, ...] | None = None) -> dict:
    """The groups of ``axes`` (by default the non-"model" axes) flattened
    into one line, for every other coordinate.  Ranks lie row-major on the
    mesh (as ``init_device_mesh`` lays them), so a line's sorted ranks are
    in the axes' order; every rank makes every group, in the same order."""
    if axes is None:
        axes = tuple(n for n in names if n != "model")
    if len(axes) < 2:
        return {}
    idx = [names.index(a) for a in axes]
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    lines = np.moveaxis(grid, idx, list(range(len(idx))))
    lines = lines.reshape(int(np.prod([shape[i] for i in idx])), -1).T
    me, mine = dist.get_rank(), None
    for line in lines:
        g = dist.new_group(sorted(int(r) for r in line))
        if me in line:
            mine = g
    return {axes: mine}


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
    dm = init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))
    return Mesh(dm, dev, _flat_groups(tuple(shape), tuple(names)))


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


def make_pod_mesh(pods: int, model: int = 1,
                  device: DeviceLike = None) -> Mesh:
    """The ("pod", "data", "model") mesh over every rank: ``pods`` pods of
    world / (pods · model) data shards each.  The schemes split the batch
    over the flattened ("pod", "data") line, pod-major, as the JAX package
    does on its multi-pod meshes."""
    dev = local_device(device)
    init_distributed(dev)
    world = dist.get_world_size()
    if pods < 1 or model < 1 or world % (pods * model):
        raise ValueError(f"{pods} pods × model {model} must divide the "
                         f"{world} ranks of the job")
    return device_mesh((pods, world // (pods * model), model),
                       ("pod", "data", "model"), dev)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The production mesh: 16×16 over ("data", "model"), or 2×16×16 over
    ("pod", "data", "model") with ``multi_pod``, built over a fake process
    group of 256 or 512 ranks in this process, as rank 0 (the JAX
    package's ``--xla_force_host_platform_device_count=512``).  Its
    collectives move nothing: it is for the dry run's fake tensors.  Besides
    the data axes' flattened line, the mesh holds the line of all its axes
    (the dp scheme shards the samples over every axis).

    Refuses to run when a default process group exists: it never joins or
    replaces a real one.  The caller ends the fake group with
    ``torch.distributed.destroy_process_group()``."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists; the production "
                           "mesh is built over a fake group of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = local_device(device)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        dm = init_device_mesh(dev.type, shape, mesh_dim_names=names)
        flat = {**_flat_groups(shape, names),
                **_flat_groups(shape, names, names)}
    except BaseException:
        dist.destroy_process_group()
        raise
    return Mesh(dm, dev, flat)


def data_axis_names(mesh: Mesh) -> tuple[str, ...]:
    return tuple(ax for ax in mesh.axis_names if ax != "model")


def data_parallel_size(mesh: Mesh) -> int:
    out = 1
    for ax in data_axis_names(mesh):
        out *= mesh.shape[ax]
    return out


def make_host_mesh(model: int = 1, device: DeviceLike = None) -> Mesh:
    """The mesh over whatever this job has, as the JAX package's
    ``launch/mesh.make_host_mesh`` builds it (``ClusterRuntime.mesh`` calls
    it): one data axis and the model axis, the "pod" axis folded into the
    data axis.  :func:`make_pod_mesh` keeps the two data axes apart."""
    return make_mesh(model, device)
