"""Mamba2 (SSD — state-space duality) block: the chunked scan of prefill and
the constant-state decode step.

Mirrors ``repro.models.mamba2``.  Prefill runs the minimal SSD chunked
algorithm (arXiv:2405.21060): the sequence is split into chunks, the
intra-chunk terms are batched products, and the inter-chunk recurrence is a
sequential loop over chunk states, in the reference's order (its
``lax.scan``).  It is plain PyTorch: the reference computes it with einsums
outside any Pallas kernel, so there is no kernel to port.

Decode carries ``state (B, H, P, N)`` in fp32, the LM analogue of the MPS
left environment.  Casts happen where the reference's happen: the SSD and
the decode update run in fp32 (``jnp.einsum`` promotes the model-dtype B and
C beside an fp32 state; here they are cast), ``y`` is cast to the model's
dtype before the gated RMS norm, and the norm's output again before
``* norm_g``.  ``dt`` is ``logaddexp(x, 0)`` as ``jax.nn.softplus`` (torch's
``softplus`` switches to x above a threshold).

On a sharded rank (``tp``, a ``common.TPLayout`` with ``ssm``) the block
runs on the rank's H/p heads (:func:`mamba2_specs`; ``w_in``'s tile is
its 1/p of each of x, z, B, C and dt): x, z and dt are the rank's heads',
B and C are gathered over the model axis in one all-gather, the SSD and
the decode update run on the rank's heads (and its tile of the state),
the gated norm's mean over d_inner is the mean of the ranks' means over
their heads ((B, S, 1) fp32, summed over the axis), and ``w_out``'s
row-split products are summed over it.  On a mesh of one rank the same
code runs every head, its collectives over the one rank.  Heads the
model axis does not divide (``w_in`` whole) run whole on every rank,
``w_out`` still split on its rows (the smoke config's 8 heads on 16).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as C
from repro_torch.models.common import (MODEL, PartSplit, TPLayout,
                                       dense_init, model_enter, model_psum,
                                       spec)


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 128           # N
    d_head: int = 64             # P
    n_heads: int = 0             # H; 0 → 2·d_model/d_head (expand=2)
    n_groups: int = 1            # G (B/C groups, GQA-like)
    chunk: int = 128

    @property
    def heads(self) -> int:
        return self.n_heads or (2 * self.d_model // self.d_head)

    @property
    def d_inner(self) -> int:
        return self.heads * self.d_head


def mamba2_init(gen: torch.Generator, cfg: Mamba2Config, dtype,
                device=None) -> dict:
    """The block's weights by name, in the reference's shapes: the fused
    input projection w_in (dm, [x di, z di, B g·n, C g·n, dt h]), w_out,
    and A_log, D, dt_bias (fp32) and norm_g (di,) at the reference's
    values."""
    dm, di, g, n, h = (cfg.d_model, cfg.d_inner, cfg.n_groups, cfg.d_state,
                       cfg.heads)
    return {
        "w_in": dense_init(gen, dm, 2 * di + 2 * g * n + h, dtype, device),
        "w_out": dense_init(gen, di, dm, dtype, device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float64,
                                          device=device).float()),
        "D": torch.ones((h,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm_g": torch.ones((di,), dtype=dtype, device=device),
    }


def mamba2_specs(cfg: Mamba2Config) -> dict:
    """The block's logical specs by weight name (the reference's
    ``mamba2_init``): ``w_in`` split on its columns (as the model axis'
    :class:`~repro_torch.models.common.PartSplit` of its five parts: a
    rank's tile is its share of each, the bytes of the reference's
    contiguous tile), ``w_out`` on its rows, ``norm_g`` on d_inner, the
    per-head vectors whole."""
    gn = cfg.n_groups * cfg.d_state            # x, z, B, C, dt
    parts = (cfg.d_inner, cfg.d_inner, gn, gn, cfg.heads)
    return {"w_in": spec(None, PartSplit(MODEL, parts)),
            "w_out": spec(MODEL, None), "A_log": spec(None),
            "D": spec(None), "dt_bias": spec(None), "norm_g": spec(MODEL)}


class SSMState(NamedTuple):
    state: torch.Tensor          # (B, H, P, N) fp32
    conv: torch.Tensor           # (B, 1): the reference's unused placeholder


def init_ssm_state(batch: int, cfg: Mamba2Config, dtype,
                   device=None) -> SSMState:
    return SSMState(
        torch.zeros((batch, cfg.heads, cfg.d_head, cfg.d_state),
                    dtype=torch.float32, device=device),
        torch.zeros((batch, 1), dtype=dtype, device=device))


def _split_proj(z: torch.Tensor, cfg: Mamba2Config):
    """z (…, w_in's width) → x, z gate, B, C, dt."""
    di, g, n, h = cfg.d_inner, cfg.n_groups, cfg.d_state, cfg.heads
    return torch.split(z, [di, di, g * n, g * n, h], dim=-1)


def chunk_len(s: int, chunk: int) -> int:
    """The largest chunk ≤ ``chunk`` that divides S (a prime S gives 1)."""
    ln = min(chunk, s)
    while s % ln:
        ln -= 1
    return ln


def _ssd_chunked(x, dt, a, b, c, cfg: Mamba2Config):
    """Minimal SSD.  x (B, S, H, P); dt (B, S, H); a (H,) < 0; b, c (B, S,
    G, N).  Returns y (B, S, H, P) and the final state (B, H, P, N), over
    chunks of :func:`chunk_len`."""
    bsz, s, h, p = x.shape
    n = b.shape[3]
    ln = chunk_len(s, cfg.chunk)
    nc = s // ln
    rep = h // b.shape[2]

    bc = b.repeat_interleave(rep, dim=2).reshape(bsz, nc, ln, h, n)
    cc = c.repeat_interleave(rep, dim=2).reshape(bsz, nc, ln, h, n)
    xc = x.reshape(bsz, nc, ln, h, p)
    dtc = dt.reshape(bsz, nc, ln, h)

    cum = torch.cumsum(dtc * a, dim=2)                  # (B, nc, L, H)
    seg_total = cum[:, :, -1]                           # (B, nc, H)

    # intra-chunk: decay(i ← j) = exp(cum_i − cum_j) for i ≥ j.  Acausal
    # entries have diff > 0 and their exp may overflow: they are selected
    # away by a where, never multiplied by a mask (inf · 0 = NaN)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,L,L,H)
    causal = torch.ones((ln, ln), dtype=torch.bool,
                        device=x.device).tril()[None, None, :, :, None]
    decay = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                        0.0)
    del diff
    scores = torch.einsum("bclhn,bckhn->bclkh", cc, bc) * decay
    del decay
    y_intra = torch.einsum("bclkh,bckh,bckhp->bclhp", scores, dtc, xc)
    del scores

    # chunk input to state: Σ_j exp(cum_last − cum_j)·dt_j·B_j ⊗ x_j
    in_decay = torch.exp(seg_total[:, :, None, :] - cum)       # (B,nc,L,H)
    chunk_state = torch.einsum("bclh,bclh,bclhn,bclhp->bchpn",
                               in_decay, dtc, bc, xc)          # (B,nc,H,P,N)

    # inter-chunk recurrence over the chunks, in order
    state = torch.zeros((bsz, h, p, n), dtype=x.dtype, device=x.device)
    prev = []
    decay_seg = torch.exp(seg_total)                           # (B, nc, H)
    for i in range(nc):
        prev.append(state)
        state = state * decay_seg[:, i, :, None, None] + chunk_state[:, i]
    prev_states = torch.stack(prev, dim=1)                     # (B,nc,H,P,N)

    # state to output within each chunk: C_i · exp(cum_i) · state_prev
    y_inter = torch.einsum("bclhn,bclh,bchpn->bclhp", cc, torch.exp(cum),
                           prev_states)
    return (y_intra + y_inter).reshape(bsz, s, h, p), state


def _rank_proj(params, x: torch.Tensor, cfg: Mamba2Config, tp: TPLayout):
    """The rank's x, z gate and dt columns (its heads') of ``x @ w_in``'s
    tile, B and C whole (one all-gather of the ranks' adjacent B and C
    columns over the model axis, stacked on dim 0 in rank order), and the
    rank's heads' slice of the per-head vectors (their gradient summed
    over the axis)."""
    if cfg.n_groups != 1:
        raise NotImplementedError("a sharded Mamba2 block with B/C groups")
    p, h_l = tp.size, cfg.heads // tp.size
    di_l, gn_l = h_l * cfg.d_head, cfg.d_state // p
    xi, zg, bc, dtr = torch.split(model_enter(x, tp) @ params["w_in"],
                                  [di_l, di_l, 2 * gn_l, h_l], dim=-1)
    bc = C.gather_forward(bc, tp.group).unflatten(0, (p, x.shape[0]))
    bc = bc.unflatten(-1, (2, gn_l))                  # (p, B, S, 2, N/p)
    b, c = (bc[..., i, :].movedim(0, -2).flatten(-2) for i in (0, 1))
    heads = slice(tp.rank * h_l, (tp.rank + 1) * h_l)
    vec = {k: model_enter(params[k], tp)[heads]
           for k in ("A_log", "D", "dt_bias")}
    return xi, zg, b, c, dtr, vec


def mamba2_apply(params, x: torch.Tensor, cfg: Mamba2Config,
                 state: Optional[SSMState] = None,
                 tp: Optional[TPLayout] = None):
    """x (B, S, D) → (out (B, S, D), new state).  Without ``state``: the
    chunked prefill, new state None.  With ``state``: one decode step (S
    must be 1); ``state`` is not written, the new one is returned.  With
    ``tp.ssm``: the rank's heads (``state`` and the new state the rank's
    (B, H/p, P, N)), ``out`` summed over the model axis (on one rank every
    head, through the same collectives)."""
    bsz, s, _ = x.shape
    p, n, g = cfg.d_head, cfg.d_state, cfg.n_groups
    split = tp is not None and tp.ssm
    # the heads whole on every rank, w_out split on its rows (heads the
    # model axis does not divide): the rank's rows of the output, each
    # replicated weight's and x's gradient summed over the axis
    rows = (tp is not None and not tp.ssm
            and params["w_out"].shape[0] < cfg.d_inner)

    if split:
        xi, zg, b, c, dtr, vec = _rank_proj(params, x, cfg, tp)
    else:
        vec = params
        if rows:
            x = model_enter(x, tp)
            vec = {k: model_enter(params[k], tp)
                   for k in ("w_in", "A_log", "D", "dt_bias")}
        xi, zg, b, c, dtr = _split_proj(x @ vec["w_in"], cfg)
    h = dtr.shape[-1]                                          # the heads
    xi = xi.reshape(bsz, s, h, p)
    b = b.reshape(bsz, s, g, n)
    c = c.reshape(bsz, s, g, n)
    dt = torch.logaddexp(dtr.float() + vec["dt_bias"],
                         torch.zeros((), device=x.device))     # (B, S, H)
    a = -torch.exp(vec["A_log"])                               # (H,) < 0

    if state is None:
        y, _ = _ssd_chunked(xi.float(), dt, a, b.float(), c.float(), cfg)
        new_state = None
    else:
        if s != 1:
            raise ValueError(f"a decode step takes one token, got S = {s}")
        rep = h // g
        bh = b[:, 0].repeat_interleave(rep, dim=1).float()    # (B, H, N)
        ch = c[:, 0].repeat_interleave(rep, dim=1).float()
        dt0 = dt[:, 0]                                         # (B, H)
        dec = torch.exp(dt0 * a[None, :])
        upd = torch.einsum("bh,bhn,bhp->bhpn", dt0, bh, xi[:, 0].float())
        st = state.state * dec[:, :, None, None] + upd
        y = torch.einsum("bhn,bhpn->bhp", ch, st)[:, None]     # (B,1,H,P)
        new_state = SSMState(st, state.conv)

    y = y + xi.to(y.dtype) * vec["D"][None, None, :, None]
    y = y.reshape(bsz, s, h * p).to(x.dtype)
    # gated RMS norm (Mamba2's norm before the output projection); split,
    # its mean over d_inner is the mean of the ranks' means over their
    # heads (each d_inner/p wide; on one rank the one-device mean's bits)
    y32 = y.float() * F.silu(zg.float())
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    if split:
        var = C.psum_shared(var, tp.group) / tp.size
    y = (y32 * torch.rsqrt(var + 1e-6)).to(x.dtype)
    if rows:
        n_l = params["w_out"].shape[0]
        y = y[..., tp.rank * n_l:(tp.rank + 1) * n_l]
    out = (y * params["norm_g"]) @ params["w_out"]
    return (model_psum(out, tp) if split or rows else out), new_state
