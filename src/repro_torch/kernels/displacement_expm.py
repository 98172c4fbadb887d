"""Batched displacement operator D(μ) (paper §3.4.1): a Hopper kernel beside
its plain version.

D(μ) ≈ e^{−|μ|²/2}·exp(μa†)·exp(−μ*a) on the d-dimensional truncated Fock
space, with closed-form triangular factors
``L[j, m] = μ^{j−m}·c[j, m]`` and ``U[m, k] = (−μ*)^{k−m}·c[k, m]``,
``c[j, m] = √(j!/m!)/(j−m)!`` (:func:`coeff_table`).

:func:`displacement_expm` launches the CUDA kernel of
``csrc/displacement_expm.cu`` (which replaces the Pallas TPU kernel
``repro/kernels/displacement_expm.py::displacement_expm``; the source's
header says how the design differs) for CUDA tensors, and takes its plain
version, :func:`displacement_expm_plain`, only for tensors on the CPU.

Both build the powers μ^p as repeated products (``cumprod``), so μ = 0
gives the identity exactly.  Inputs are the (B,) real and imaginary parts
of μ, fp32 or fp64; outputs the (B, d, d) real and imaginary planes.

``LAUNCHES`` counts kernel launches; ``reset_launches`` sets it to 0.
"""
from __future__ import annotations

import torch

from repro_torch.core.displacement import _tri_factor_log_coeffs, powers
from repro_torch.kernels import _build

LAUNCHES = {"displacement_expm": 0}

MAX_D = 16

_ENTRY = {torch.float64: "fastmps_displacement_expm_f64",
          torch.float32: "fastmps_displacement_expm_f32"}


def reset_launches() -> None:
    LAUNCHES["displacement_expm"] = 0


def coeff_table(d: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """c[j, m] = √(j!/m!)/(j−m)! for j ≥ m, else 0: (d, d), from lgamma in
    float64 (as the reference's table), cast to ``dtype``."""
    return _tri_factor_log_coeffs(d, torch.float64, device)[1].to(dtype)


def displacement_expm_plain(mu_re, mu_im, d: int):
    """(B,) μ re/im → (B, d, d) re/im planes of D(μ), in the inputs' dtype."""
    mu = torch.complex(mu_re, mu_im)
    nu = torch.complex(-mu_re, mu_im)                 # −μ*
    c = coeff_table(d, mu_re.dtype, mu_re.device)
    j = torch.arange(d, device=mu_re.device)
    idx = (j[:, None] - j[None, :]).clamp(min=0)      # power j − m
    lower = powers(mu, d)[:, idx] * c                 # L[j, m]
    upper = (powers(nu, d)[:, idx] * c).transpose(1, 2)   # U[m, k]
    pref = torch.exp(-0.5 * (mu_re * mu_re + mu_im * mu_im))
    out = torch.matmul(lower, upper) * pref[:, None, None]
    return out.real.contiguous(), out.imag.contiguous()


def rounding_bound(mu_re, mu_im, d: int) -> torch.Tensor:
    """(B, d, d) elementwise bound on how far the kernel and the plain
    version may differ: 8·d·ε (ε of the inputs' dtype) times the summed
    magnitudes e^{−|μ|²/2}·(|L| @ |U|), in fp64.  The terms of D(μ) cancel
    toward the truncation corner (up to ~500× the result at d = 16), so a
    bound relative to D(μ) itself would not hold in either version."""
    re, im = mu_re.double(), mu_im.double()
    r = torch.sqrt(re * re + im * im)                 # |μ| = |−μ*|
    j = torch.arange(d, device=re.device)
    p = (j[:, None] - j[None, :]).clamp(min=0)
    lower = r[:, None, None] ** p * coeff_table(d, device=re.device)
    summed = torch.exp(-0.5 * r * r)[:, None, None] * (
        lower @ lower.transpose(1, 2))
    return 8 * d * torch.finfo(mu_re.dtype).eps * summed


def displacement_expm(mu_re, mu_im, d: int):
    """The kernel: μ re/im (B,), both fp32 or both fp64 → (B, d, d) re/im
    planes as :func:`displacement_expm_plain`.  d ≤ 16.  One thread per
    output element; bound by the output bytes."""
    if not 1 <= d <= MAX_D:
        raise ValueError(f"displacement_expm: d={d} outside 1..{MAX_D}")
    if mu_re.device.type == "cpu":
        return displacement_expm_plain(mu_re, mu_im, d)
    name = "displacement_expm"
    if mu_re.dtype not in _ENTRY:
        raise TypeError(f"{name}: dtype {mu_re.dtype} not supported; have "
                        f"{sorted(str(k) for k in _ENTRY)}")
    dev, dt = mu_re.device, mu_re.dtype
    coeff = coeff_table(d, dt, dev)
    _build.check_operands(name, dev, {"mu_re": (mu_re, dt),
                                      "mu_im": (mu_im, dt)})
    if mu_re.ndim != 1 or mu_im.shape != mu_re.shape:
        raise ValueError(f"{name}: expected μ re/im (B,); got "
                         f"{tuple(mu_re.shape)} and {tuple(mu_im.shape)}")
    b = mu_re.shape[0]
    if not 1 <= b < 2 ** 31:
        raise ValueError(f"{name}: batch {b} outside the kernel's grid")
    out_re = torch.empty((b, d, d), dtype=dt, device=dev)
    out_im = torch.empty((b, d, d), dtype=dt, device=dev)
    _build.launch(_ENTRY[dt], (mu_re, mu_im, coeff, out_re, out_im), (b, d),
                  dev, name, source="displacement_expm")
    LAUNCHES[name] += 1
    return out_re, out_im
