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
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init


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


def mamba2_apply(params, x: torch.Tensor, cfg: Mamba2Config,
                 state: Optional[SSMState] = None):
    """x (B, S, D) → (out (B, S, D), new state).  Without ``state``: the
    chunked prefill, new state None.  With ``state``: one decode step (S
    must be 1); ``state`` is not written, the new one is returned."""
    bsz, s, _ = x.shape
    h, p, n, g = cfg.heads, cfg.d_head, cfg.d_state, cfg.n_groups

    z = x @ params["w_in"]
    xi, zg, b, c, dtr = _split_proj(z, cfg)
    xi = xi.reshape(bsz, s, h, p)
    b = b.reshape(bsz, s, g, n)
    c = c.reshape(bsz, s, g, n)
    dt = torch.logaddexp(dtr.float() + params["dt_bias"],
                         torch.zeros((), device=x.device))     # (B, S, H)
    a = -torch.exp(params["A_log"])                            # (H,) < 0

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

    y = y + xi.to(y.dtype) * params["D"][None, None, :, None]
    y = y.reshape(bsz, s, cfg.d_inner).to(x.dtype)
    # gated RMS norm (Mamba2's norm before the output projection)
    y32 = y.float() * F.silu(zg.float())
    var = torch.mean(y32 * y32, dim=-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + 1e-6)).to(x.dtype) * params["norm_g"]
    return y @ params["w_out"], new_state
