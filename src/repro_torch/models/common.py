"""Initialisers and primitive layers shared by the model zoo.

Mirrors ``repro.models.common`` without its sharding helpers (``DATA``,
``MODEL``, ``resolve_specs``, ``batch_sharded``, ``shard_hint``), which
are no-ops on one device.  Casts happen where the reference casts:
:func:`rms_norm` reduces in fp32, casts to x's dtype, then multiplies by γ
in that dtype; :func:`apply_rope` rotates split halves in fp32 and casts
back; :func:`silu` rounds bf16 where the reference's sigmoid does.
Initialisers draw from a ``torch.Generator`` (their bits differ from
``jax.random``'s; weights are carried across with ``convert``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device=None) -> torch.Tensor:
    """U(−1/√in, 1/√in) of shape (in_dim, out_dim)."""
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.rand((in_dim, out_dim), generator=gen, dtype=torch.float32,
                   device=device)
    return (w * (2 * scale) - scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device=None) -> torch.Tensor:
    """N(0, 0.02²) of shape (vocab, dim)."""
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * gamma


def silu(x: torch.Tensor) -> torch.Tensor:
    """x·σ(x).  In bf16, σ(x) = 1/(1 + exp(−x)) with a bf16 rounding after
    each op, as the reference's ``jax.nn.sigmoid`` computes it on the CPU
    (XLA expands ``logistic`` so); a one-step rounding differs from it on
    about a third of bf16 inputs, and a one-ulp difference can flip an MoE
    route downstream."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def swiglu(x, w_gate, w_up, w_down):
    return (silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x, w_up, b_up, w_down, b_down):
    return F.gelu(x @ w_up + b_up, approximate="tanh") @ w_down + b_down


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype,
             style: str = "swiglu", device=None) -> dict:
    """The MLP's weights by name, shapes as the reference's."""
    if style == "swiglu":
        return {"gate": dense_init(gen, d_model, d_ff, dtype, device),
                "up": dense_init(gen, d_model, d_ff, dtype, device),
                "down": dense_init(gen, d_ff, d_model, dtype, device)}
    return {"up": dense_init(gen, d_model, d_ff, dtype, device),
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
            "down": dense_init(gen, d_ff, d_model, dtype, device),
            "b_down": torch.zeros((d_model,), dtype=dtype, device=device)}


def mlp_apply(params, x, style: str = "swiglu"):
    if style == "swiglu":
        return swiglu(x, params["gate"], params["up"], params["down"])
    return gelu_mlp(x, params["up"], params["b_up"], params["down"],
                    params["b_down"])


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, Dh); positions (..., S) integer.  Rotates split halves
    (not interleaved pairs) in fp32 and casts back to x's dtype."""
    dh = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=x.device) / dh))
    ang = positions[..., None].to(torch.float32) * inv     # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy.  logits (B, S, V), labels (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    nll = logz - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
