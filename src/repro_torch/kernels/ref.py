"""Plain oracle for the fused site step (mirrors ``repro.kernels.ref``)."""
from __future__ import annotations

import torch

from repro_torch.core.precision import real_dtype_of


def site_step_ref(env, gamma, lam, u, semantics="linear",
                  scaling="per_sample"):
    """contract → measure → normalise/cumsum/draw with the supplied
    uniforms u (N,) → collapse (×λ for born) → per-sample rescale.

    Returns (env' (N, χ), samples (N,) int64, dlog (N,)).
    """
    temp = torch.einsum("nl,lrs->nrs", env, gamma)
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
