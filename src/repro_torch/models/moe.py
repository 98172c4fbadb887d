"""Mixture-of-Experts layer with per-row capacity dispatch.

Mirrors ``repro.models.moe``: a fp32 router, softmax, top-k with the gates
renormalised, a (B, E, C, D) capacity buffer per batch row (GShard-style
groups, C from :func:`_capacity`), the expert SwiGLU GEMMs over every
expert's C slots, the combine and an optional shared MLP added after.

What differs from the reference, and why:

* **top-k ties** go to the lower expert index, as ``jax.lax.top_k``'s do:
  the probabilities are sorted with a stable descending sort
  (``torch.topk`` promises no order among equal values).
* **position in expert** comes from a stable sort of the row's flattened
  expert ids, as ``jnp.argsort``'s; a slot past the capacity goes to a sink
  that is thrown away.
* **the combine has no atomics.**  The reference scatter-adds every slot
  into a zeroed (S + 1, D) buffer in the model's dtype; its slots are
  expert-major, so a token's terms arrive in ascending expert order.  Here
  each token gathers its k terms (a dropped one reads a zero row), sorts
  them by expert id and adds them one after another in the model's dtype,
  from zero: the reference's order, and the same bits on every run (a
  ``index_add_`` in bf16 on the card adds in no fixed order).
* the buffer is kept expert-major, (E, B·C, D), so the expert GEMMs are
  three ``torch.bmm``s without a copy of the weights; the reference's
  einsums compute the same products outside any Pallas kernel.

On a sharded rank (``tp``, a ``common.TPLayout``; the reference's
``moe_init`` specs, :func:`moe_specs`) the layer is expert parallel, as
XLA partitions the reference's (B → data, E → model) buffer: every rank
routes its batch rows whole (the router is replicated), fills only its
E/p experts' slots, runs the three ``bmm``s on its expert tiles, adds its
experts' weighted terms in ascending expert order and sums the (B, S, D)
result over the model axis in one all-reduce (the reference's "local
scatters + one all-reduce").  The shared expert is a SwiGLU MLP split as
the dense one.  ``lb_loss`` and ``drop_frac`` are the global batch's: the
expert counts, the summed router probabilities and the kept count are
summed over the data axes before the product, so every rank holds the
reference's values.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as C
from repro_torch.models.common import (MODEL, TPLayout, dense_init,
                                       mlp_apply, mlp_specs, model_enter,
                                       model_psum, project_rows, silu, spec)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                  # per-expert hidden
    n_experts: int
    top_k: int
    n_shared: int = 0          # deepseek-style always-on shared experts
    capacity_factor: float = 1.25
    router_dtype: torch.dtype = torch.float32


def _scaled_normal(gen: torch.Generator, shape, scale: float, dtype,
                   device) -> torch.Tensor:
    """N(0, scale²) of ``shape`` (E, …) in ``dtype``, drawn one expert at a
    time so that the fp32 draw never holds a whole stack of experts."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for e in range(shape[0]):
        w = torch.randn(shape[1:], generator=gen, dtype=torch.float32,
                        device=device)
        out[e] = (w * scale).to(dtype)
    return out


def moe_init(gen: torch.Generator, cfg: MoEConfig, dtype,
             device=None) -> dict:
    """The layer's weights by name, in the reference's shapes: ``router``
    (dm, E) fp32 whatever ``dtype``, ``gate``/``up`` (E, dm, df), ``down``
    (E, df, dm), and with ``n_shared`` a ``shared`` MLP of width
    df·n_shared."""
    e, dm, df = cfg.n_experts, cfg.d_model, cfg.d_ff
    params = {
        "router": dense_init(gen, dm, e, torch.float32, device),
        "gate": _scaled_normal(gen, (e, dm, df), dm ** -0.5, dtype, device),
        "up": _scaled_normal(gen, (e, dm, df), dm ** -0.5, dtype, device),
        "down": _scaled_normal(gen, (e, df, dm), df ** -0.5, dtype, device),
    }
    if cfg.n_shared:
        width = df * cfg.n_shared
        params["shared"] = {"gate": dense_init(gen, dm, width, dtype, device),
                            "up": dense_init(gen, dm, width, dtype, device),
                            "down": dense_init(gen, width, dm, dtype, device)}
    return params


def moe_specs(cfg: MoEConfig) -> dict:
    """The layer's logical specs by weight name (the reference's
    ``moe_init``): the experts split on the expert axis over the model axis,
    the router whole, the shared expert as a SwiGLU MLP."""
    out = {"router": spec(None, None), "gate": spec(MODEL, None, None),
           "up": spec(MODEL, None, None), "down": spec(MODEL, None, None)}
    if cfg.n_shared:
        out["shared"] = mlp_specs("swiglu")
    return out


def _capacity(tokens_per_group: int, cfg: MoEConfig) -> int:
    """Slots per expert and batch row: ⌈int(cf·S·k) / E⌉, rounded up to a
    multiple of 8 when it is at least 8 (a one-token decode row gets 1)."""
    c = -(-int(cfg.capacity_factor * tokens_per_group * cfg.top_k)
          // cfg.n_experts)
    if c >= 8:
        return -(-c // 8) * 8
    return max(1, c)


def top_k_lower_first(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, in
    descending order, equal values by ascending index (``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _positions(eids: torch.Tensor) -> torch.Tensor:
    """eids (B, S, k) → each choice's position among its row's choices of
    the same expert, in flattened (token-major) order."""
    b = eids.shape[0]
    flat = eids.reshape(b, -1)
    order = torch.argsort(flat, dim=-1, stable=True)
    sorted_e = torch.gather(flat, -1, order)
    n = flat.shape[1]
    pos_sorted = (torch.arange(n, device=eids.device)
                  - torch.searchsorted(sorted_e, sorted_e))
    return torch.empty_like(flat).scatter_(-1, order, pos_sorted).view(
        eids.shape)


def _router_stats(eids: torch.Tensor, probs: torch.Tensor, keep, e: int,
                  tp: Optional[TPLayout]):
    """(me, ce, kept): the share of the top-k choices each expert got, the
    mean router probability of each expert and the share of choices kept,
    over the global batch.  On a rank whose data axes hold more than one
    rank (``tp.data``) its sums are summed over them in one all-reduce,
    whose backward sums ce's cotangent over them too
    (``collectives.psum_shared``: every data rank's loss reads the global
    ce whole, and the train step averages their gradients)."""
    onehot = F.one_hot(eids, e).to(torch.float32)
    kept = keep.to(torch.float32)
    if tp is None or tp.data is None:
        return onehot.mean(dim=(0, 1, 2)), probs.mean(dim=(0, 1)), \
            kept.mean()
    sums = C.psum_shared(torch.cat([onehot.sum(dim=(0, 1, 2)),
                                    probs.sum(dim=(0, 1)),
                                    kept.sum()[None]]), tp.data)
    n = C.axis_size(tp.data)
    choices, tokens = kept.numel() * n, probs.shape[0] * probs.shape[1] * n
    return sums[:e] / choices, sums[e:2 * e] / tokens, sums[-1] / choices


def moe_apply(params, x: torch.Tensor, cfg: MoEConfig,
              tp: Optional[TPLayout] = None):
    """x (B, S, D) → (y (B, S, D), aux).  aux holds the reference's
    ``lb_loss`` and ``drop_frac`` (fp32 scalars) and ``expert_ids`` (B, S,
    k), each token's route.  Capacity is per batch row: C =
    :func:`_capacity` (S).  With ``tp`` (a sharded rank, see the module
    docstring) ``params`` are its tiles, x its batch rows, and y the sum
    over the model axis of its experts' terms."""
    b, s, dm = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(s, cfg)
    dev = x.device
    split = tp is not None and tp.experts
    e_l = params["gate"].shape[0]                  # this rank's experts
    e0 = tp.rank * e_l if split else 0

    logits = project_rows(x.to(cfg.router_dtype), params["router"])
    probs = torch.softmax(logits, dim=-1)                         # (B, S, E)
    gate_w, eids = top_k_lower_first(probs, k)                    # (B, S, k)
    gate_w = gate_w / gate_w.sum(dim=-1, keepdim=True)

    # dispatch: slot (e, b, c) of the expert-major buffer holds token
    # tok_of_slot; overflow, and on a sharded rank another rank's expert,
    # goes to the sink slot E_l·B·C
    pos = _positions(eids)
    keep = pos < cap
    mine = keep & (eids >= e0) & (eids < e0 + e_l)
    rows = torch.arange(b, device=dev)[:, None, None]
    slot = torch.where(mine, ((eids - e0) * b + rows) * cap + pos,
                       e_l * b * cap)
    tok = torch.arange(s, device=dev)[None, :, None].expand(b, s, k)
    sink_tok = b * (s + 1) - 1                                    # a zero row
    tok_of_slot = torch.full((e_l * b * cap + 1,), sink_tok,
                             dtype=torch.int64, device=dev)
    tok_of_slot[slot.reshape(-1)] = (rows * (s + 1) + tok).reshape(-1)
    xe = model_enter(x, tp) if split else x
    x_pad = torch.cat([xe, xe.new_zeros((b, 1, dm))], dim=1).reshape(-1, dm)
    buf = x_pad.index_select(0, tok_of_slot[:-1]).view(e_l, b * cap, dm)

    # expert GEMMs: gate, up (E_l, D, F) and down (E_l, F, D)
    h = silu(torch.bmm(buf, params["gate"]))
    h = h * torch.bmm(buf, params["up"])
    out = torch.bmm(h, params["down"]).view(e_l * b * cap, dm)
    out = torch.cat([out, out.new_zeros((1, dm))])                # sink: 0

    # combine: each token's kept terms, weighted in the model's dtype, added
    # in ascending expert order from zero (the reference's scatter order);
    # another rank's terms read the sink's zero
    _, perm = torch.sort(eids, dim=-1, stable=True)
    slot_sorted = torch.gather(slot, -1, perm)
    gates = model_enter(gate_w, tp) if split else gate_w
    gate_sorted = torch.gather(torch.where(keep, gates, 0.0), -1, perm)
    terms = out.index_select(0, slot_sorted.reshape(-1)).view(b, s, k, dm)
    terms = terms * gate_sorted.to(out.dtype)[..., None]
    y = torch.zeros((b, s, dm), dtype=out.dtype, device=dev)
    for j in range(k):
        y = y + terms[:, :, j]
    if split:
        y = model_psum(y, tp)
    y = y.to(x.dtype)

    if cfg.n_shared:
        y = y + mlp_apply(params["shared"], x.reshape(b * s, dm),
                          tp=tp).reshape(b, s, dm)

    # load-balance aux loss (Switch-style), over the global batch
    me, ce, kept = _router_stats(eids, probs, keep, e, tp)
    aux = {"lb_loss": e * torch.sum(me * ce), "drop_frac": 1.0 - kept,
           "expert_ids": eids}
    return y, aux


__all__ = ["MoEConfig", "moe_apply", "moe_init", "moe_specs",
           "top_k_lower_first"]
