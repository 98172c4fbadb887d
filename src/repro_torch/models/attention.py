"""Grouped-query self- and cross-attention with optional QKV bias and
RoPE, and MLA.

Mirrors ``repro.models.attention``.
Parameters keep the reference's shapes (wq (dm, h, dh), wk/wv (dm, kvh,
dh), wo (h, dh, dm), biases (h, dh) and (kvh, dh); MLA's six weights) in an
``nn.ParameterDict``, so carrying weights across is a copy.

Full-sequence attention (``cache is None``: prefill) and every
cross-attention (``kv_input`` given: K/V projected from it, no rope, no
causal mask, no cache written; in decode too, at one query row) go through
``kernels.ops.flash_attention``: the CUDA flash kernel on the card, its
plain version on the CPU (``kernels="auto" | "cuda" | "torch"``).  The
reference's global ``USE_FLASH`` switch, off by default there, is the
``flash`` argument here, on by default: with it off they go through the
plain :func:`_sdpa` (the reference's op for op), as training needs.  Decode
self-attention (``cache`` given) keeps the plain :func:`_sdpa`, as the
reference keeps its XLA path.  The decode write index may be a scalar or
one position per row (B,); the cache tensors are written in place.

MLA (:func:`mla_apply`, DeepSeek-V3's multi-head latent attention) caches
the compressed latent (kv_lora_rank + rope dim) instead of per-head K/V and
stays plain PyTorch in prefill and decode, as the reference keeps it on
its XLA path: it has no kernel.  On a sharded rank (the reference's
``mla_init`` specs, :func:`mla_specs`) prefill and training split it over
the heads (wq_b, wk_b, wv_b column parallel, wo row parallel and summed
over the model axis; wq_a and wkv_a whole, their products entering the
split heads).  Decode reads a latent cache split on its length: the rank
gathers the query heads and wk_b, wv_b over the model axis, runs every
head over its rows of the cache and sums softmax's max, sum and output
over the axis, as XLA partitions the reference's (PERF.md §6).

On a sharded rank (``tp``, a ``common.TPLayout``) the dense self- and
cross-attention run on its tiles as XLA partitions the reference's: the
query heads (and the KV heads when they divide) column parallel, wo row
parallel and summed over the model axis; in prefill, and in every
cross-attention (its K/V from the rank's rows of ``kv_input``), a rank
whose KV heads are whole projects only those its query heads read; in
decode a KV cache split on its length
(``launch.steps.cache_shardings``) is read with every query head (gathered
over the model axis) and a softmax whose max, sum and output are summed
over the axis (:func:`_sdpa_split`).  Differentiated (training's prefill
route), a replicated input that enters split heads has its gradient
summed over the model axis (``common.model_enter``), and so have wk, wv
(bk, bv) where a rank projects only part of the whole KV heads.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import collectives as C
from repro_torch.kernels import ops
from repro_torch.models.common import (MODEL, RowTile, TPLayout,
                                       apply_rope, dense_init, model_enter,
                                       model_psum, project_rows, rope_tables,
                                       spec)

NEG_INF = -1e30


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


def attn_specs(cfg: AttnConfig) -> dict:
    """The attention weights' logical specs by name (the reference's
    ``attn_init``): q, k, v split on their heads, wo on its rows."""
    specs = {"wq": spec(None, MODEL, None), "wk": spec(None, MODEL, None),
             "wv": spec(None, MODEL, None), "wo": spec(MODEL, None, None)}
    if cfg.qkv_bias:
        specs.update({"bq": spec(MODEL, None), "bk": spec(MODEL, None),
                      "bv": spec(MODEL, None)})
    return specs


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
    """x (B, S, dm) · w (dm, heads, dh) → (B, S, heads, dh); ``w`` may be a
    ``common.RowTile`` of such a weight (its products summed over the model
    axis)."""
    if isinstance(w, RowTile):
        rows, heads, dh = w.tile.shape
        flat = w._replace(tile=w.tile.reshape(rows, heads * dh))
        return project_rows(x, flat).view(*x.shape[:2], heads, dh)
    dm, heads, dh = w.shape
    return (x @ w.reshape(dm, heads * dh)).view(*x.shape[:2], heads, dh)


def _write_rows(pairs, length: torch.Tensor) -> torch.Tensor:
    """For each (buf (B, T, …), new (B, s, …)) of ``pairs``, write new into
    buf in place at each row's ``length`` (a scalar or (B,)), clamped into
    the buffer as ``dynamic_update_slice`` clamps its start; returns the
    lengths (B,)."""
    buf, new = pairs[0]
    b, s = new.shape[:2]
    t = buf.shape[1]
    pos = length.expand(b) if length.ndim == 0 else length
    start = pos.clamp(0, t - s).to(torch.int64)
    rows = start[:, None] + torch.arange(s, device=buf.device)    # (B, s)
    batch = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    for buf, new in pairs:
        buf[batch, rows] = new.to(buf.dtype)
    return pos


def attn_apply(params, x: torch.Tensor, cfg: AttnConfig,
               positions: Optional[torch.Tensor] = None,
               cache: Optional[KVCache] = None,
               kv_input: Optional[torch.Tensor] = None,
               kernels: str = "auto", rope=None, flash: bool = True,
               tp: Optional[TPLayout] = None):
    """Self- or cross-attention.  Returns (y, new_cache), new_cache None
    without a cache or with ``kv_input``.  ``rope``: ``common.rope_tables(
    positions, head_dim, rope_theta)``, if the caller made them once for
    every layer.  ``flash=False`` is the reference's default route
    (``USE_FLASH = False``): full-sequence and cross attention through
    :func:`_sdpa`, causal by a ``tril`` mask; it is the route training
    takes (the flash kernel has no backward).

    * prefill: ``cache is None`` → full causal (or full, if not causal)
      attention through the flash kernel's dispatch;
    * decode: ``cache`` given, x is (B, s, D) → write at ``cache.length``
      (clamped into the cache, as ``dynamic_update_slice``) and attend to
      ``[0, length]``;
    * cross: ``kv_input`` (B, T, D) given → K/V from it, no rope, no causal
      mask, the cache (if any) neither written nor read: the flash
      kernel's dispatch at S query rows against T keys.
    """
    if tp is not None:
        return _attn_apply_tp(params, x, cfg, positions, cache, kernels,
                              rope, flash, tp, kv_input)
    b, s, _ = x.shape
    src = x if kv_input is None else kv_input
    q = _project(x, params["wq"])
    k = _project(src, params["wk"])
    v = _project(src, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.rope and kv_input is None:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        rope = rope or rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta, rope)
        k = apply_rope(k, positions, cfg.rope_theta, rope)

    new_cache = None
    if cache is not None and kv_input is None:
        t = cache.k.shape[1]
        pos = _write_rows(((cache.k, k), (cache.v, v)), cache.length)
        valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
        out = _sdpa(q, cache.k, cache.v, valid[:, None, None, None, :])
        new_cache = KVCache(cache.k, cache.v, cache.length + s)
    elif flash:
        out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(),
                                  causal=cfg.causal and kv_input is None,
                                  kernels=kernels)
    else:
        mask = None
        if cfg.causal and kv_input is None:
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=x.device).tril()[None, None, None]
        out = _sdpa(q, k, v, mask)
    h, dh, dm = params["wo"].shape
    y = out.reshape(b, s, h * dh) @ params["wo"].reshape(h * dh, dm)
    return y, new_cache


def _write_rows_at(pairs, length: torch.Tensor, offset: int,
                   t_all: int) -> torch.Tensor:
    """:func:`_write_rows` into this rank's rows [offset, offset + T_l) of
    a cache of ``t_all`` rows split on its length: the start clamped into
    the whole cache, each row written by the rank that holds it.  Returns
    the lengths (B,)."""
    buf, new = pairs[0]
    b, s = new.shape[:2]
    t_l = buf.shape[1]
    pos = length.expand(b) if length.ndim == 0 else length
    start = pos.clamp(0, t_all - s).to(torch.int64) - offset
    batch = torch.arange(b, device=buf.device)
    for j in range(s):                    # one row a sequence per write
        row = start + j
        keep = (row >= 0) & (row < t_l)
        row = row.clamp(0, t_l - 1)
        for buf, new in pairs:
            k = keep.view(b, *[1] * (buf.dim() - 2))
            buf[batch, row] = torch.where(k, new[:, j].to(buf.dtype),
                                          buf[batch, row])
    return pos


def _sdpa_split(q, k, v, mask, tp: Optional[TPLayout]):
    """:func:`_sdpa` over a KV cache split on its length across the model
    axis: every rank scores all of ``q`` against its keys, the softmax's
    max and sum and the output are summed over the axis (None: a whole
    cache, :func:`_sdpa` itself)."""
    if tp is None:
        return _sdpa(q, k, v, mask)
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    logits = logits / math.sqrt(dh)
    logits = torch.where(mask, logits, NEG_INF)
    m = C.pmax(logits.amax(dim=-1, keepdim=True), tp.group)
    e = torch.exp(logits - m)
    z = C.psum(e.sum(dim=-1, keepdim=True), tp.group)
    w = (e / z).to(v.dtype)
    out = C.psum(torch.einsum("bkgst,btkd->bskgd", w, v), tp.group)
    return out.reshape(b, s, h, dh)


def _attn_apply_tp(params, x, cfg: AttnConfig, positions, cache, kernels,
                   rope, flash, tp: TPLayout, kv_input=None):
    """:func:`attn_apply` on a sharded rank's tiles (see the module
    docstring); a cross-attention (``kv_input``, batch-sharded as x) as a
    prefill's, in decode too.  Returns (y, new_cache)."""
    b, s, _ = x.shape
    cross = kv_input is not None
    if cross:
        cache = None                  # neither read nor written
    if tp.heads:
        x = model_enter(x, tp)
        if cross:
            kv_input = model_enter(kv_input, tp)
    src = kv_input if cross else x
    q = _project(x, params["wq"])                 # (B, S, H_l, Dh)
    h_l = q.shape[2]
    h0 = tp.rank * h_l if tp.heads else 0
    kv = slice(None)
    names = ("wk", "wv", "bk", "bv") if cfg.qkv_bias else ("wk", "wv")
    w = {n: params[n] for n in names}
    if cache is None and tp.heads and not tp.kv_heads:
        # prefill: only the KV heads of this rank's query heads (XLA slices
        # the replicated wk, wv so); ranks that share a KV head each give
        # a part of its weights' gradient, summed over the model axis
        g = cfg.n_heads // cfg.n_kv_heads
        if h_l % g and g % h_l:
            raise NotImplementedError(
                f"{h_l} query heads a rank straddle KV groups of {g}")
        kv = slice(h0 // g, (h0 + h_l - 1) // g + 1)
        w = {n: model_enter(t, tp) for n, t in w.items()}
    whole = kv == slice(None)     # a decode step's KV weights: RowTiles too
    k = _project(src, w["wk"] if whole else w["wk"][:, kv])
    v = _project(src, w["wv"] if whole else w["wv"][:, kv])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + w["bk"][kv]
        v = v + w["bv"][kv]
    if cfg.rope and not cross:
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        rope = rope or rope_tables(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta, rope)
        k = apply_rope(k, positions, cfg.rope_theta, rope)
    new_cache = None
    if cache is None:
        if tp.kv_heads and not tp.heads:
            k = C.all_gather(k, tp.group, dim=2)
            v = C.all_gather(v, tp.group, dim=2)
        causal = cfg.causal and not cross
        if flash:
            out = ops.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal,
                                      kernels=kernels)
        else:
            mask = None
            if causal:
                mask = torch.ones((s, s), dtype=torch.bool,
                                  device=x.device).tril()[None, None, None]
            out = _sdpa(q, k, v, mask)
    elif tp.cache == "heads":
        t = cache.k.shape[1]
        pos = _write_rows(((cache.k, k), (cache.v, v)), cache.length)
        valid = torch.arange(t, device=x.device)[None, :] <= pos[:, None]
        out = _sdpa(q, cache.k, cache.v, valid[:, None, None, None, :])
        new_cache = KVCache(cache.k, cache.v, cache.length + s)
    else:
        # the cache's rows [off, off + T_l) on this rank (all of them when
        # it is whole): every query head reads them
        if tp.heads:
            q = C.all_gather(q, tp.group, dim=2)
        t_l = cache.k.shape[1]
        split = tp.cache == "length"
        off = tp.rank * t_l if split else 0
        pos = _write_rows_at(((cache.k, k), (cache.v, v)), cache.length,
                             off, t_l * tp.size if split else t_l)
        valid = (torch.arange(off, off + t_l, device=x.device)[None, :]
                 <= pos[:, None])
        out = _sdpa_split(q, cache.k, cache.v,
                          valid[:, None, None, None, :], tp if split else None)
        out = out[:, :, h0:h0 + h_l]
        new_cache = KVCache(cache.k, cache.v, cache.length + s)
    _, dh, dm = params["wo"].shape
    y = out.reshape(b, s, h_l * dh) @ params["wo"].reshape(h_l * dh, dm)
    return (model_psum(y, tp) if tp.heads else y), new_cache



# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V3).  The cache stores the
# compressed latent (kv_lora_rank + rope_head_dim) instead of per-head K/V.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    head_dim: int = 128          # nope head dim
    rope_head_dim: int = 64
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512


def mla_init(gen: torch.Generator, cfg: MLAConfig, dtype,
             device=None) -> dict:
    """MLA's six weights by name, in the reference's shapes: wq_a (dm,
    q_lora), wq_b (q_lora, h, dh + dr), wkv_a (dm, kv_lora + dr), wk_b and
    wv_b (kv_lora, h, dh), wo (h, dh, dm)."""
    dm, h = cfg.d_model, cfg.n_heads
    dh, dr, ql, kl = (cfg.head_dim, cfg.rope_head_dim, cfg.q_lora_rank,
                      cfg.kv_lora_rank)
    return {
        "wq_a": dense_init(gen, dm, ql, dtype, device),
        "wq_b": dense_init(gen, ql, h * (dh + dr), dtype, device).reshape(
            ql, h, dh + dr),
        "wkv_a": dense_init(gen, dm, kl + dr, dtype, device),
        "wk_b": dense_init(gen, kl, h * dh, dtype, device).reshape(kl, h, dh),
        "wv_b": dense_init(gen, kl, h * dh, dtype, device).reshape(kl, h, dh),
        "wo": dense_init(gen, h * dh, dm, dtype, device).reshape(h, dh, dm),
    }


class MLACache(NamedTuple):
    latent: torch.Tensor    # (B, cache_len, kv_lora_rank + rope_head_dim)
    length: torch.Tensor    # () or (B,) int: tokens already in the cache


def init_mla_cache(batch: int, cache_len: int, cfg: MLAConfig, dtype,
                   device=None) -> MLACache:
    return MLACache(
        torch.zeros((batch, cache_len, cfg.kv_lora_rank + cfg.rope_head_dim),
                    dtype=dtype, device=device),
        torch.zeros((), dtype=torch.int32, device=device))


def mla_specs() -> dict:
    """MLA's logical specs by weight name (the reference's ``mla_init``):
    the down projections whole, the up projections on the heads, wo on its
    rows."""
    return {"wq_a": spec(None, None), "wq_b": spec(None, MODEL, None),
            "wkv_a": spec(None, None), "wk_b": spec(None, MODEL, None),
            "wv_b": spec(None, MODEL, None), "wo": spec(MODEL, None, None)}


def mla_apply(params, x: torch.Tensor, cfg: MLAConfig,
              positions: Optional[torch.Tensor] = None,
              cache: Optional[MLACache] = None, rope=None,
              tp: Optional[TPLayout] = None):
    """Prefill (``cache is None``: causal over x) or decode (the latent
    written at ``cache.length``, a scalar or one per row, and attended up
    to it).  Returns (y, new_cache), new_cache None without one.  q_rope
    turns at ``positions``, k_rope at the context positions, both with the
    default θ = 10⁴, as the reference's.  ``rope``: the (q, k) pair of
    ``common.rope_tables`` at those positions (k at the rows of this
    rank's cache), if the caller made them once for every layer.  ``tp``:
    a sharded rank's layout (see the module docstring)."""
    b, s, _ = x.shape
    h, dh, dr, r = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, \
        cfg.kv_lora_rank
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    heads = tp is not None and tp.heads

    q_a = project_rows(x, params["wq_a"])
    q = _project(model_enter(q_a, tp) if heads else q_a,
                 params["wq_b"])                                  # (B,S,H,·)
    h_l = q.shape[2]
    q_nope, q_rope = q[..., :dh], q[..., dh:]
    q_tables, k_tables = rope or (None, None)
    q_rope = apply_rope(q_rope, positions, tables=q_tables)

    latent = project_rows(x, params["wkv_a"])                     # (B,S,r+dr)
    wk, wv = params["wk_b"], params["wv_b"]
    split = (cache is not None and tp is not None and tp.size > 1
             and tp.cache == "length")
    new_cache = None
    if cache is not None:
        t = cache.latent.shape[1]
        off = tp.rank * t if split else 0
        pairs = ((cache.latent, latent),)
        lengths = (_write_rows_at(pairs, cache.length, off, t * tp.size)
                   if split else _write_rows(pairs, cache.length))
        latent_ctx = cache.latent
        ctx_pos = torch.arange(off, off + t, device=x.device)[None, :]
        new_cache = MLACache(cache.latent, cache.length + s)
        if split and heads:
            # every head over this rank's rows of the cache
            q_nope = C.all_gather(q_nope, tp.group, dim=2)
            q_rope = C.all_gather(q_rope, tp.group, dim=2)
            wk = C.all_gather(wk, tp.group, dim=1)
            wv = C.all_gather(wv, tp.group, dim=1)
    else:
        latent_ctx = model_enter(latent, tp) if heads else latent
        ctx_pos = positions
        t = s

    c_kv, k_rope_in = latent_ctx[..., :r], latent_ctx[..., r:]
    k_rope = apply_rope(k_rope_in[:, :, None, :], ctx_pos,
                        tables=k_tables)[:, :, 0, :]
    k_nope = _project(c_kv, wk)                                   # (B,T,H,dh)
    v = _project(c_kv, wv)

    logits = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshk,btk->bhst", q_rope, k_rope)).float()
    logits.div_(math.sqrt(dh + dr))
    if cache is not None:
        mask = (ctx_pos <= lengths[:, None])[:, None, None, :]    # (B,1,1,T)
    else:
        mask = torch.tril(torch.ones((s, t), dtype=torch.bool,
                                     device=x.device))[None, None]
    logits.masked_fill_(~mask, NEG_INF)
    if split:
        m = C.pmax(logits.amax(dim=-1, keepdim=True), tp.group)
        e = torch.exp(logits - m)
        del logits
        z = C.psum(e.sum(dim=-1, keepdim=True), tp.group)
        w = (e / z).to(v.dtype)
        out = C.psum(torch.einsum("bhst,bthk->bshk", w, v), tp.group)
        h0 = tp.rank * h_l if heads else 0
        out = out[:, :, h0:h0 + h_l]
    else:
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        del logits
        out = torch.einsum("bhst,bthk->bshk", w, v)
    hh, dhh, dm = params["wo"].shape
    y = out.reshape(b, s, hh * dhh) @ params["wo"].reshape(hh * dhh, dm)
    return (model_psum(y, tp) if heads else y), new_cache
