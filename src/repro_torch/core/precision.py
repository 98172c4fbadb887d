"""Adaptive rescaling of the environment (paper §3.3) and precision policies.

Scaling modes, as in ``repro.core.precision``:

- ``none``       — no rescale (reproduces the Fig. 6 underflow failure);
- ``global``     — one scalar (the batch max) per call;
- ``per_sample`` — each sample divided by its own max; the measurement is
  normalised right after, so the factor cancels.

``rescale`` also returns the per-sample log10 of the factor, which the
sampler accumulates as ``log_scale``.
"""
from __future__ import annotations

import torch


def real_dtype_of(dtype: torch.dtype) -> torch.dtype:
    return torch.empty((), dtype=dtype).real.dtype if dtype.is_complex \
        else dtype


def rescale(env: torch.Tensor, mode: str = "per_sample"
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rescale env (N, χ); returns (env', log10 factor per sample (N,))."""
    n = env.shape[0]
    rdt = real_dtype_of(env.dtype)
    if mode == "none":
        return env, torch.zeros((n,), dtype=rdt, device=env.device)
    a = env.abs()
    if mode == "global":
        m = a.max()
        factor = torch.where(m > 0, m, 1.0).to(rdt)
        return env / factor, torch.log10(factor).expand(n)
    if mode == "per_sample":
        m = a.amax(dim=1, keepdim=True)                       # (N, 1)
        factor = torch.where(m > 0, m, 1.0).to(rdt)
        return env / factor, torch.log10(factor[:, 0])
    raise ValueError(f"unknown scaling mode: {mode}")


# name: (storage dtype, GEMM input dtype, accumulation dtype).  The bf16
# tiers of the JAX package (``mxu_bf16``, ``store_bf16``) are not ported yet.
POLICIES = {
    "fp64": (torch.float64, torch.float64, torch.float64),
    "fp32": (torch.float32, torch.float32, torch.float32),
}


def policy_dtypes(name: str):
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown precision policy {name!r}; "
                         f"have {list(POLICIES)}") from None
