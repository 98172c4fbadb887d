"""Plain oracles for the kernels (mirror ``repro.kernels.ref``).

``compute_dtype=torch.bfloat16`` (linear stages): the GEMM operands are
rounded to bf16 (fp64 through fp32) and their exact products summed in
fp32, as the JAX package's xla cells compute the ``mxu_bf16`` and
``store_bf16`` tiers; the contraction comes back in env's dtype, the
``measure`` and ``collapse`` stages in fp32.
"""
from __future__ import annotations

import torch

from repro_torch.core.precision import real_dtype_of, rounded


def _contract(env, gamma, compute_dtype):
    """temp (N, R, d) = env · Γ, under bf16 inputs in env's dtype."""
    if compute_dtype is None:
        return torch.einsum("nl,lrs->nrs", env, gamma)
    return torch.einsum("nl,lrs->nrs", rounded(env, compute_dtype),
                        rounded(gamma, compute_dtype)).to(env.dtype)


def contract_measure_ref(env, gamma, lam, compute_dtype=None):
    """Site contraction + linear measurement (paper Fig. 1 + Alg. 1 l.1):
    env (N, L) · Γ (L, R, d) → temp (N, R, d); probs (N, d) = temp · Λ."""
    temp = _contract(env, gamma, compute_dtype)
    return temp, torch.einsum("nrs,r->ns", temp, lam.to(temp.dtype))


def collapse_rescale_ref(temp, samples):
    """Collapse the physical leg at the drawn outcome + per-sample rescale
    (§3.3): env'[n, r] = temp[n, r, s_n] / max_r |temp[n, r, s_n]|."""
    env = torch.take_along_dim(temp, samples[:, None, None].to(torch.int64),
                               dim=2)[:, :, 0]
    m = env.abs().amax(dim=1, keepdim=True)
    return env / torch.where(m > 0, m, 1.0)


def displacement_zassenhaus_ref(mu_re, mu_im, d: int):
    """Batched D(μ) ≈ e^{−|μ|²/2} e^{μa†} e^{−μ*a} as split re/im planes:
    (B,) real pairs → (B, d, d) re and im planes, assembled in complex128
    by ``core.displacement.displacement_zassenhaus`` and cast back."""
    from repro_torch.core.displacement import displacement_zassenhaus
    mu = torch.complex(mu_re.to(torch.float64), mu_im.to(torch.float64))
    out = displacement_zassenhaus(mu, d)
    return out.real.to(mu_re.dtype), out.imag.to(mu_re.dtype)


def collapse_select_ref(env, gamma, samples, compute_dtype=None):
    """env (N, L), Γ (L, R, d), samples (N,) → env' (N, R) = env·Γ[:, :, s_n]
    (fp32 under bf16 inputs)."""
    temp = _contract(env, gamma, compute_dtype)
    if compute_dtype is not None:
        temp = temp.to(torch.float32)
    return torch.take_along_dim(temp, samples[:, None, None].to(torch.int64),
                                dim=2)[:, :, 0]


def measure_first_probs_ref(env, gamma, lam, compute_dtype=None):
    """probs via associativity: env @ (Γ·Λ) — equals
    ``contract_measure_ref(...)[1]`` in exact arithmetic.  Under bf16
    inputs W = Γ·Λ is built in fp32 and rounded with env (the tp-3
    ``measure`` cell), fp32 out."""
    if compute_dtype is None:
        return env @ torch.einsum("lrs,r->ls", gamma, lam)
    w = torch.einsum("lrs,r->ls", gamma.to(torch.float32),
                     lam.to(torch.float32))
    return rounded(env, compute_dtype) @ rounded(w, compute_dtype)


def site_step_ref(env, gamma, lam, u, semantics="linear",
                  scaling="per_sample", compute_dtype=None):
    """contract → measure → normalise/cumsum/draw with the supplied
    uniforms u (N,) → collapse (×λ for born) → per-sample rescale;
    ``compute_dtype`` applies to linear only.

    Returns (env' (N, χ), samples (N,) int64, dlog (N,)).
    """
    temp = _contract(env, gamma,
                     compute_dtype if semantics == "linear" else None)
    if semantics == "linear":
        probs = torch.einsum("nrs,r->ns", temp, lam.to(temp.dtype))
    else:
        scaled = temp * lam[None, :, None]
        probs = torch.sum(scaled.abs() ** 2, dim=1)
    probs = torch.clamp(probs, min=0.0)
    total = torch.sum(probs, dim=1, keepdim=True)
    safe = torch.where(total > 0,
                       probs / torch.where(total > 0, total, 1.0),
                       torch.ones_like(probs) / probs.shape[1])
    cdf = torch.cumsum(safe, dim=1)
    samples = torch.sum((u[:, None] > cdf).to(torch.int64), dim=1).clamp(
        0, probs.shape[1] - 1)
    env_new = torch.take_along_dim(temp, samples[:, None, None], dim=2)[:, :, 0]
    if semantics == "born":
        env_new = env_new * lam[None, :]
    rdt = real_dtype_of(env_new.dtype)
    if scaling == "per_sample":
        m = env_new.abs().amax(dim=1, keepdim=True)
        factor = torch.where(m > 0, m, 1.0).to(rdt)
        return env_new / factor, samples, torch.log10(factor[:, 0])
    return env_new, samples, torch.zeros((env.shape[0],), dtype=rdt,
                                         device=env.device)


def flash_attention_ref(q, k, v, causal: bool = True):
    """Naive softmax attention (GQA-aware): q (B, S, H, Dh), k/v
    (B, T, KVH, Dh) → (B, S, H, Dh); scores in fp32 from the inputs' dtype,
    weights cast to v's dtype."""
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, k).to(torch.float32)
    logits = logits / torch.sqrt(torch.tensor(dh, dtype=torch.float32))
    if causal:
        mask = torch.tril(torch.ones((s, t), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(v.dtype), v)
    return out.reshape(b, s, h, dh)
