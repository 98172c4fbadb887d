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
    if dim == 0:
        return buf
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


# ---------------------------------------------------------------------------
# Differentiable collectives of a model split over a group (the LM's
# tensor- and data-parallel training).  The loss is computed alike on every
# rank of the group, so a cotangent that reaches a replicated tensor is the
# same on every rank: Megatron's pair (``psum_forward``, ``psum_backward``)
# and the gather's adjoint (``gather_forward``) give each rank the gradient
# of that one loss.  ``torch.distributed.nn.functional.all_reduce`` sums
# the gradient in its backward too, which would count such a loss once a
# rank.  Outside a graph (no grad, or an input that needs none) they are
# the plain functions above.
# ---------------------------------------------------------------------------

def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _psum_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Σ over the group, scattered in tiles along ``dim`` (the adjoint of
    :func:`all_gather` along it)."""
    p = axis_size(group)
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((moved.shape[0] // p, *moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(_real(out), _real(moved),
                               op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim)


class _PsumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _PsumShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


class _GatherForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter_dim(g, ctx.group, ctx.dim), None, None


def psum_forward(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group, the gradient passed through as it is (Megatron's
    g): the partial sums of a row-parallel product or of a split
    lookup."""
    if _recording(x):
        return _PsumForward.apply(x, group)
    return psum(x, group)


def psum_backward(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, its gradient summed over the group (Megatron's f): a
    replicated tensor that enters weights split over the group, each rank's
    gradient being the part of its tile."""
    if _recording(x):
        return _PsumBackward.apply(x, group)
    return x


def psum_shared(x: torch.Tensor, group) -> torch.Tensor:
    """Σ over the group, its gradient summed over the group too: a total
    that each rank reads for its own part of the result, so that each
    rank's cotangent of it is a part and the adjoint sums them.  Over the
    data axes: an MoE layer's router statistics of the global batch, read
    whole by every data rank's loss (the train step averages the data
    ranks' gradients).  Over the model axis: a Mamba2 block's sum of
    squares over d_inner, which each rank's heads are normed by."""
    if _recording(x):
        return _PsumShared.apply(x, group)
    return psum(x, group)


def gather_forward(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` along ``dim``, its gradient summed over the group
    and scattered back to this rank's tile (an FSDP weight's gather)."""
    if _recording(x):
        return _GatherForward.apply(x, group, dim)
    return all_gather(x, group, dim)
