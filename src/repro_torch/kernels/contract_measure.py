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

``compute_dtype=torch.bfloat16`` (the ``mxu_bf16``/``store_bf16`` tiers)
rounds env and Γ to bf16 and sums in fp32 on the tensor cores (the wgmma
kernel, fed by TMA from bf16 operands in scratch: env's rounded copy and,
unless Γ is bf16 with 16-byte aligned rows, Γ's, :func:`gemm_scratch`);
temp comes out in env's dtype, as the JAX package's ``contract_parallel``
casts it.

``LAUNCHES`` counts kernel launches (one per call that reached the card,
the bf16 entry apart); ``reset_launches`` sets them to 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.site_step import (_BF16, _F32, _F64,
                                           check_compute_dtype,
                                           contract_plain, linear_probs_plain,
                                           padded, supported)

LAUNCHES = {"contract_measure": 0, "contract_measure_bf16": 0}

_ENTRY = {(_F64, _F64): "fastmps_contract_measure_f64",
          (_F32, _F32): "fastmps_contract_measure_f32"}
_BF16_ENTRY = {(_F32, _F32): "fastmps_contract_measure_bf16_f32_f32",
               (_F32, _BF16): "fastmps_contract_measure_bf16_f32_bf16",
               (_F64, _F64): "fastmps_contract_measure_bf16_f64_f64"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def contract_measure_plain(env, gamma, lam, compute_dtype=None):
    """env (N, L), Γ (L, R, d), Λ (R) → (temp (N, R, d), probs (N, d))."""
    temp = contract_plain(env, gamma, compute_dtype)
    return temp, linear_probs_plain(temp, lam)


def contract_measure(env, gamma, lam, compute_dtype=None):
    """The kernel → (temp, probs) as :func:`contract_measure_plain`.  env,
    Γ and Λ all fp32 or all fp64: a tiled GEMM writes temp (on the fp64
    tensor cores for fp64), bound by its operations (2·N·L·R·d) at the full
    width.  ``compute_dtype=torch.bfloat16``: env and Γ fp32, env fp32
    with a bf16 Γ, or both fp64 (Λ in env's dtype), on the bf16 tensor
    cores.  Then a second pass sums probs per row in a fixed order."""
    name = "contract_measure"
    check_compute_dtype(compute_dtype, name)
    if env.device.type == "cpu":
        return contract_measure_plain(env, gamma, lam, compute_dtype)
    if compute_dtype is None:
        entry = supported(_ENTRY, name, env, gamma)
    else:
        entry = supported(_BF16_ENTRY, name + " (bf16 inputs)", env, gamma)
        name += "_bf16"
    _build.check_operands(name, env.device, {
        "env": (env, env.dtype), "gamma": (gamma, gamma.dtype),
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
    scratch = () if compute_dtype is None else gemm_scratch(env, gamma)
    _build.launch(entry, (env, gamma, lam, temp, probs, *scratch),
                  (n, chi_l, chi_r, d), env.device, name)
    _build.count_launch(LAUNCHES, name)
    return temp, probs


def gemm_scratch(env, gamma):
    """The bf16 entry's scratch: env rounded to bf16 (N, padded(L)), and Γ's
    rounded copy (L, padded(R·d)) — or None, where Γ is bf16 with rows of
    16-byte aligned length and address, which TMA reads as it lies (200 MB
    of copy at the p₂ = 4 shard shapes saved in store_bf16)."""
    n, chi_l = env.shape
    ncols = gamma.shape[1] * gamma.shape[2]
    env16 = torch.empty((n, padded(chi_l)), dtype=torch.bfloat16,
                        device=env.device)
    if (gamma.dtype == torch.bfloat16 and ncols % 8 == 0
            and gamma.data_ptr() % 16 == 0):
        return env16, None
    return env16, torch.empty((chi_l, padded(ncols)), dtype=torch.bfloat16,
                              device=env.device)
