"""Grouped-query self-attention with optional QKV bias and RoPE.

Mirrors ``repro.models.attention`` for the dense family.  Parameters keep
the reference's shapes (wq (dm, h, dh), wk/wv (dm, kvh, dh), wo (h, dh, dm),
biases (h, dh) and (kvh, dh)) in an ``nn.ParameterDict``, so carrying
weights across is a copy.

Full-sequence attention (``cache is None``: prefill) goes through
``kernels.ops.flash_attention``: the CUDA flash kernel on the card, its
plain version on the CPU (``kernels="auto" | "cuda" | "torch"``; the
reference's global ``USE_FLASH`` switch becomes this dispatch).  Decode
(``cache`` given) keeps the plain :func:`_sdpa`, as the reference keeps
its XLA path.  The decode write index may be a scalar or one position per
row (B,); the cache tensors are written in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, dense_init

NEG_INF = -1e30
_ROW = "ROADMAP.md §1 row"


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True


def attn_init(gen: torch.Generator, cfg: AttnConfig, dtype,
              device=None) -> dict:
    """The attention weights by name, in the reference's shapes."""
    h, kvh, dh, dm = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    params = {
        "wq": dense_init(gen, dm, h * dh, dtype, device).reshape(dm, h, dh),
        "wk": dense_init(gen, dm, kvh * dh, dtype, device).reshape(dm, kvh,
                                                                   dh),
        "wv": dense_init(gen, dm, kvh * dh, dtype, device).reshape(dm, kvh,
                                                                   dh),
        "wo": dense_init(gen, h * dh, dm, dtype, device).reshape(h, dh, dm),
    }
    if cfg.qkv_bias:
        params.update({
            "bq": torch.zeros((h, dh), dtype=dtype, device=device),
            "bk": torch.zeros((kvh, dh), dtype=dtype, device=device),
            "bv": torch.zeros((kvh, dh), dtype=dtype, device=device)})
    return params


class KVCache(NamedTuple):
    k: torch.Tensor         # (B, cache_len, kvH, Dh)
    v: torch.Tensor
    length: torch.Tensor    # () or (B,) int: tokens already in the cache


def init_kv_cache(batch: int, cache_len: int, cfg: AttnConfig, dtype,
                  device=None) -> KVCache:
    shape = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def _sdpa(q, k, v, mask: Optional[torch.Tensor]):
    """q (B, S, H, Dh), k/v (B, T, KVH, Dh); GQA by head-group broadcast.
    Scores rounded to the inputs' dtype, then fp32, as the reference's."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits / math.sqrt(dh)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, s, h, dh)


def _project(x, w):
    """x (B, S, dm) · w (dm, heads, dh) → (B, S, heads, dh)."""
    dm, heads, dh = w.shape
    return (x @ w.reshape(dm, heads * dh)).view(*x.shape[:2], heads, dh)


def attn_apply(params, x: torch.Tensor, cfg: AttnConfig,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[KVCache] = None,
               kv_input: Optional[torch.Tensor] = None,
               kernels: str = "auto"):
    """Self-attention.  Returns (y, new_cache), new_cache None without one.

    * prefill: ``cache is None`` → full causal (or full, if not causal)
      attention through the flash kernel's dispatch;
    * decode: ``cache`` given, x is (B, s, D) → write at ``cache.length``
      (clamped into the cache, as ``dynamic_update_slice``) and attend to
      ``[0, length]``.
    """
    if kv_input is not None:
        raise NotImplementedError(
            f"cross-attention (kv_input) is not ported yet ({_ROW} 17)")
    b, s, _ = x.shape
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        t = cache.k.shape[1]
        pos = cache.length.expand(b) if cache.length.ndim == 0 \
            else cache.length
        start = pos.clamp(0, t - s).to(torch.int64)
        rows = start[:, None] + torch.arange(s, device=x.device)   # (B, s)
        batch = torch.arange(b, device=x.device)[:, None].expand(b, s)
        cache.k[batch, rows] = k.to(cache.k.dtype)        # in place
        cache.v[batch, rows] = v.to(cache.v.dtype)
        valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
        out = _sdpa(q, cache.k, cache.v, valid[:, None, None, None, :])
        new_cache = KVCache(cache.k, cache.v, cache.length + s)
    else:
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=cfg.causal,
                                  kernels=kernels)
    h, dh, dm = params["wo"].shape
    y = out.reshape(b, s, h * dh) @ params["wo"].reshape(h * dh, dm)
    return y, new_cache

