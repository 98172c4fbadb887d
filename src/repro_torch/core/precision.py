"""Adaptive rescaling of the environment (paper §3.3) and precision policies.

Scaling modes, as in ``repro.core.precision``:

- ``none``       — no rescale (reproduces the Fig. 6 underflow failure);
- ``global``     — one scalar (the batch max) per call;
- ``per_sample`` — each sample divided by its own max; the measurement is
  normalised right after, so the factor cancels.

``rescale`` also returns the per-sample log10 of the factor, which the
sampler accumulates as ``log_scale``; ``sample_range_stats`` gives the
axes of the paper's Fig. 5.
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


def sample_range_stats(env: torch.Tensor) -> dict[str, torch.Tensor]:
    """The Fig. 5 axes: per-sample max and max/min-nonzero ratio."""
    a = env.abs()
    smax = a.amax(dim=1)
    smin = torch.where(a > 0, a, torch.inf).amin(dim=1)
    return {"sample_max": smax, "range_ratio": smax / smin}


# name: (storage dtype, GEMM input dtype, accumulation dtype), the JAX
# package's tiers: ``mxu_bf16`` feeds the GEMMs bf16 inputs and sums in fp32
# (the paper's TF32 tier); ``store_bf16`` also stores Γ in bf16 (its
# FP16-storage tier), while the environment stays fp32.
POLICIES = {
    "fp64": (torch.float64, torch.float64, torch.float64),
    "fp32": (torch.float32, torch.float32, torch.float32),
    "mxu_bf16": (torch.float32, torch.bfloat16, torch.float32),
    "store_bf16": (torch.bfloat16, torch.bfloat16, torch.float32),
}


def policy_dtypes(name: str):
    try:
        return POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown precision policy {name!r}; "
                         f"have {list(POLICIES)}") from None


def rounded(x: torch.Tensor, dtype: torch.dtype,
            acc: torch.dtype = torch.float32) -> torch.Tensor:
    """``x`` rounded to the GEMM input ``dtype`` and held in ``acc``.  fp64
    rounds to a half type through fp32, as torch's and XLA's casts do on the
    CPU.  A product of two bf16 values is exact in fp32, so an fp32 GEMM of
    rounded operands is the bf16-input, fp32-accumulate GEMM."""
    if dtype in (torch.bfloat16, torch.float16) and x.dtype == torch.float64:
        x = x.to(torch.float32)
    return x.to(dtype).to(acc)


def gemm(a: torch.Tensor, b: torch.Tensor, policy: str = "fp32"
         ) -> torch.Tensor:
    """dot(a, b) under a named precision policy, contracting a's last axis
    with b's first (``repro.core.precision.gemm``)."""
    _, in_dt, acc_dt = policy_dtypes(policy)
    return torch.tensordot(rounded(a, in_dt, acc_dt),
                           rounded(b, in_dt, acc_dt), dims=([a.ndim - 1], [0]))
