"""The collectives of ``core/parallel.py`` as functions of a tensor and a
process group (the port's counterparts of ``jax.lax.psum``, ``psum_scatter``,
``pmax``, ``axis_index``, ``axis_size`` and ``ppermute`` inside
``shard_map``).

Every function returns a new tensor and leaves its input alone.  Complex
tensors cross the wire as their real view (a sum of complex numbers is the
sum of their parts), so NCCL and gloo see only real dtypes.  Nothing falls
back: a tensor on the CPU in a NCCL group, or on the card in a gloo group,
raises in the backend.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(group) -> int:
    return dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's index in ``group`` (its coordinate on the mesh axis)."""
    return dist.get_rank(group)


def _real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group (all-reduce)."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(_real(out), op=dist.ReduceOp.SUM, group=group)
    return out


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """max over the group (all-reduce) of a real tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def psum_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group, scattered in tiles along dim 1
    (``psum_scatter(x, axis, scatter_dimension=1, tiled=True)``):
    x (N, C, ...) → rank k's (N, C/p, ...) = Σ x[:, k·C/p:(k+1)·C/p, ...]."""
    p = axis_size(group)
    n, c, *rest = x.shape
    if c % p:
        raise ValueError(f"psum_scatter: dim 1 of size {c} does not split "
                         f"over {p} ranks")
    # reduce_scatter_tensor splits dim 0: lay the tiles out there first
    tiles = x.reshape(n, p, c // p, *rest).movedim(1, 0).reshape(
        p * n, c // p, *rest)
    out = torch.empty((n, c // p, *rest), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(_real(out), _real(tiles),
                               op=dist.ReduceOp.SUM, group=group)
    return out


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order."""
    p = axis_size(group)
    x = x.contiguous()
    # the output is the inputs stacked along dim 0 (what gloo asks for)
    buf = torch.empty((p * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(_real(buf), _real(x), group=group)
    return torch.cat(list(buf.reshape(p, *x.shape).unbind(0)), dim=dim)


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """Send x along ``perm`` (pairs of group ranks (src, dst), each rank at
    most once a source and once a destination); a rank that no pair
    targets gets zeros, as with ``jax.lax.ppermute``."""
    me = axis_index(group)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    out = torch.zeros_like(x)
    if dst and src and dst[0] == me == src[0]:
        return x.clone()
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, _real(x.contiguous()),
                              dist.get_global_rank(group, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, _real(out),
                              dist.get_global_rank(group, src[0]), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out
