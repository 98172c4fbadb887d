"""int8 block-quantised gradients for a cross-pod all-reduce.

Per 256-element block one fp32 scale (the block's max |x| / 127) and 256
int8 values: 4.125 bits an element on the wire instead of 16 for bf16.
:func:`compressed_psum` sums over a ``torch.distributed`` process group
(``core.collectives``' ``pmax`` and ``psum``): MAX of the scales first,
then the values requantised to that shared scale and summed as int32.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.collectives import pmax, psum

BLOCK = 256


def int8_compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) → (int8 values (n_blocks, 256), fp32 scales
    (n_blocks,)); the tail is padded with zeros, an all-zero block gets
    scale 0 and values 0."""
    flat = x.reshape(-1).float()
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.where(scale > 0, scale, 1.0))
    return q.to(torch.int8), scale[:, 0]


def int8_decompress(q: torch.Tensor, scale: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    """The inverse of :func:`int8_compress`: values × scales, the padding
    cut, reshaped to ``shape`` in ``dtype``."""
    flat = (q.float() * scale[:, None]).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape).to(dtype)


def compressed_psum(x: torch.Tensor, group) -> torch.Tensor:
    """Σ of x over ``group`` through int8: quantise, take the group's max
    scale per block, requantise to it, sum the int32 values, dequantise."""
    q, scale = int8_compress(x)
    gmax = pmax(scale, group)[:, None]
    requant = torch.round(q.float() * scale[:, None]
                          / torch.where(gmax > 0, gmax, 1.0) * 127.0)
    acc = psum(requant.to(torch.int32), group)
    out = acc.float() * gmax / 127.0
    return out.reshape(-1)[:x.numel()].reshape(x.shape).to(x.dtype)
