"""Site contraction + linear measurement for the tensor-parallel schedules.

``temp[n, r, s] = Σ_l env[n, l]·Γ[l, r, s]`` and
``probs[n, s] = Σ_r temp[n, r, s]·Λ[r]`` on bond shards (L ≠ R in general):
tp_single contracts a left-bond shard (χ/p₂ → χ), tp_double's odd half-site
the same and its even half-site a right-bond shard (χ → χ/p₂).

:func:`contract_measure` launches the CUDA kernel of ``csrc/site_step.cu``
(which replaces the Pallas TPU kernel
``repro/kernels/contract_measure.py::contract_measure``; the source's header
says how the design differs) for CUDA tensors and takes its plain version,
:func:`contract_measure_plain`, only for tensors on the CPU.

``LAUNCHES`` counts kernel launches (one per call that reached the card);
``reset_launches`` sets it to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.site_step import supported

LAUNCHES = {"contract_measure": 0}

_ENTRY = {torch.float64: "fastmps_contract_measure_f64",
          torch.float32: "fastmps_contract_measure_f32"}


def reset_launches() -> None:
    LAUNCHES["contract_measure"] = 0


def contract_measure_plain(env, gamma, lam):
    """env (N, L), Γ (L, R, d), Λ (R) → (temp (N, R, d), probs (N, d))."""
    temp = torch.einsum("nl,lrs->nrs", env, gamma)
    return temp, torch.einsum("nrs,r->ns", temp, lam)


def contract_measure(env, gamma, lam):
    """The kernel: env, Γ and Λ all fp32 or all fp64 → (temp, probs) as
    :func:`contract_measure_plain`.  A tiled GEMM writes temp; a second pass
    sums probs per row in a fixed order.  Bound by fp64 operations
    (2·N·L·R·d) at the full width."""
    if env.device.type == "cpu":
        return contract_measure_plain(env, gamma, lam)
    name = "contract_measure"
    entry = supported(env, _ENTRY, name)
    _build.check_operands(name, env.device, {
        "env": (env, env.dtype), "gamma": (gamma, env.dtype),
        "lam": (lam, env.dtype)})
    if (env.ndim != 2 or gamma.ndim != 3 or gamma.shape[0] != env.shape[1]
            or lam.shape != gamma.shape[1:2]):
        raise ValueError(f"{name}: expected env (N, L), Γ (L, R, d), Λ (R); "
                         f"got {tuple(env.shape)}, {tuple(gamma.shape)}, "
                         f"{tuple(lam.shape)}")
    (n, chi_l), (chi_r, d) = env.shape, gamma.shape[1:]
    _build.check_sizes(name, d, n, chi_l, chi_r * d)
    temp = torch.empty((n, chi_r, d), dtype=env.dtype, device=env.device)
    probs = torch.empty((n, d), dtype=env.dtype, device=env.device)
    _build.launch(entry, (env, gamma, lam, temp, probs), (n, chi_l, chi_r, d),
                  env.device, name)
    LAUNCHES[name] += 1
    return temp, probs
