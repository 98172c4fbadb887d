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
Inputs are the (B,) real and imaginary parts of μ, fp32 or fp64; outputs
the (B, d, d) real and imaginary planes, the TPU kernel's layout.
:func:`displacement_expm_complex` is the same kernel on a complex (B,) μ,
writing the (B, d, d) complex tensor's memory directly (its plain version
:func:`displacement_expm_complex_plain`); ``ops.displacement_matrices``
calls it.

The kernel sums each element as a real polynomial in −|μ|² (the terms of
L·U with their common power of μ taken out) from :func:`horner_table`;
a sample whose sums reach below the dtype's smallest normal number it
forms as the plain version does, from :func:`coeff_table`.
Both versions build the powers μ^p as repeated products, so μ = 0 gives
the identity exactly.  The tables are computed once per (d, dtype,
device) and cached.

``LAUNCHES`` counts kernel launches (both layouts); ``reset_launches``
sets it to 0.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.displacement import _tri_factor_log_coeffs, powers
from repro_torch.kernels import _build

LAUNCHES = {"displacement_expm": 0}

MAX_D = 16
# samples a step of :func:`check_rounding` (bounds its fp64 temporaries)
_CHECK_CHUNK = 2 ** 17

#: subnormal spacings (the dtype's least positive number) that an element
#: whose exact value is below the dtype's smallest normal number may stand
#: from that value, in the kernel and in the plain version, beyond what
#: rounding e^{−|μ|²/2} to a subnormal number moves it
#: (:func:`check_rounding`)
SUBNORMAL_SPACINGS = 16

_ENTRY = {torch.float64: "fastmps_displacement_expm_f64",
          torch.float32: "fastmps_displacement_expm_f32"}
_COMPLEX_ENTRY = {torch.complex128: "fastmps_displacement_expm_c128",
                  torch.complex64: "fastmps_displacement_expm_c64"}


def reset_launches() -> None:
    LAUNCHES["displacement_expm"] = 0


def _device(device) -> torch.device:
    return torch.device("cpu" if device is None else device)


def coeff_table(d: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """c[j, m] = √(j!/m!)/(j−m)! for j ≥ m, else 0: (d, d), from lgamma in
    float64 (as the reference's table), cast to ``dtype``; computed once
    per (d, dtype, device), the same tensor after that (not to be written)."""
    return _coeff_table(d, dtype, _device(device))


@functools.cache
def _coeff_table(d: int, dtype, device: torch.device) -> torch.Tensor:
    return _tri_factor_log_coeffs(d, torch.float64, device)[1].to(dtype)


def horner_offset(j: int, k: int) -> int:
    """Where Q_jk's coefficients start in :func:`horner_table` (j ≥ k):
    pairs in order of j, then k, k + 1 coefficients each."""
    return j * (j + 1) * (j + 2) // 6 + k * (k + 1) // 2


def horner_table(dtype=torch.float64, device=None) -> torch.Tensor:
    """The kernel's coefficients: for j ≥ k (j < ``MAX_D``) the polynomial
    Q_jk(x) = Σ_{m ≤ k} c[j, m]·c[k, m]·x^{k−m}, so that D(μ)[j, k] =
    e^{−|μ|²/2}·z^{|j−k|}·Q_jk(−|μ|²) (z = μ below the diagonal, −μ* above
    it), its coefficient of x^k first; products in float64, cast to
    ``dtype``.  One table serves every d ≤ ``MAX_D``; cached as
    :func:`coeff_table`."""
    return _horner_table(dtype, _device(device))


@functools.cache
def _horner_table(dtype, device: torch.device) -> torch.Tensor:
    c = coeff_table(MAX_D).tolist()
    q = [c[j][m] * c[k][m] for j in range(MAX_D) for k in range(j + 1)
         for m in range(k + 1)]
    assert len(q) == horner_offset(MAX_D, 0)
    return torch.tensor(q, dtype=torch.float64).to(dtype).to(device)


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


def displacement_expm_complex_plain(mu, d: int):
    """(B,) complex μ → (B, d, d) complex D(μ): the planes of
    :func:`displacement_expm_plain`, joined."""
    return torch.complex(*displacement_expm_plain(
        mu.real.contiguous(), mu.imag.contiguous(), d))


def _summed_magnitudes(mu_re, mu_im, d: int):
    """(e^{−|μ|²/2} (B,), |L| @ |U| (B, d, d)) in fp64."""
    re, im = mu_re.double(), mu_im.double()
    r = torch.sqrt(re * re + im * im)                 # |μ| = |−μ*|
    j = torch.arange(d, device=re.device)
    p = (j[:, None] - j[None, :]).clamp(min=0)
    lower = r[:, None, None] ** p * coeff_table(d, device=re.device)
    return torch.exp(-0.5 * r * r), lower @ lower.transpose(1, 2)


def rounding_bound(mu_re, mu_im, d: int) -> torch.Tensor:
    """(B, d, d) elementwise bound on how far the kernel and the plain
    version may differ: 8·d·ε (ε of the inputs' dtype) times the summed
    magnitudes e^{−|μ|²/2}·(|L| @ |U|), in fp64.  The terms of D(μ) cancel
    toward the truncation corner (up to ~500× the result at d = 16), so a
    bound relative to D(μ) itself would not hold in either version.  It
    holds for elements whose exact value is a normal number;
    :func:`check_rounding` applies it with the rule for the others."""
    pref, lu = _summed_magnitudes(mu_re, mu_im, d)
    return 8 * d * torch.finfo(mu_re.dtype).eps * pref[:, None, None] * lu


def exact_values(mu_re, mu_im, d: int) -> tuple[torch.Tensor, torch.Tensor]:
    """D(μ)'s re/im planes in fp64, as the reference values of
    :func:`check_rounding`: for fp32 μ the plain version in fp64; for fp64
    μ the same products summed in ``numpy.longdouble`` on the host, whose
    exponent range keeps e^{−|μ|²/2} and the sums from underflowing before
    the one last rounding to fp64.  The diagonal's imaginary part is 0
    (D(μ)[j, j] is real).  Only the samples where the plain version in fp64
    puts another element below 2²⁰ times the smallest normal number go to
    the host; in the others every such element is a normal number, which
    is all the check reads of it there."""
    est = displacement_expm_plain(mu_re.double(), mu_im.double(), d)
    if mu_re.dtype == torch.float64:
        near = 2.0 ** 20 * torch.finfo(torch.float64).smallest_normal
        off = ~torch.eye(d, dtype=torch.bool, device=est[1].device)
        rows = ((est[0].abs() < near) | ((est[1].abs() < near) & off))
        rows = rows.flatten(1).any(dim=1).nonzero().flatten()
        if rows.numel():
            _exact_rows(est, mu_re, mu_im, d, rows)
    est[1].diagonal(dim1=1, dim2=2).zero_()
    return est


def _exact_rows(est, mu_re, mu_im, d: int, rows) -> None:
    """Overwrite ``rows`` of the fp64 planes ``est`` with D(μ) summed in
    ``numpy.longdouble``."""
    ld = np.longdouble
    re = mu_re[rows].cpu().numpy().astype(ld)
    im = mu_im[rows].cpu().numpy().astype(ld)
    c = coeff_table(d).numpy().astype(ld)
    j = np.arange(d)
    idx = np.clip(j[:, None] - j[None, :], 0, None)

    def factor(z):
        out = np.ones((z.shape[0], d), dtype=np.clongdouble)
        for p in range(1, d):
            out[:, p] = out[:, p - 1] * z
        return out[:, idx] * c

    out = (np.matmul(factor(re + 1j * im),
                     factor(-re + 1j * im).transpose(0, 2, 1))
           * np.exp(-(re * re + im * im) / 2)[:, None, None])
    for plane, part in zip(est, (out.real, out.imag)):
        plane[rows] = torch.from_numpy(part.astype(np.float64)).to(
            plane.device)


def check_rounding(got, want, mu_re, mu_im, d: int) -> dict:
    """How the kernel's re/im planes ``got`` and the plain version's
    ``want`` meet the rounding check.

    * An element whose exact value (:func:`exact_values`) is at or above
      the dtype's smallest normal number must lie within
      :func:`rounding_bound` of the plain version's.
    * One below it is held, in both versions, to the exact value: within
      ``SUBNORMAL_SPACINGS`` spacings (the dtype's least positive number)
      plus (|L| @ |U|)[j, k] spacings, what rounding e^{−|μ|²/2} to a
      subnormal number (half a spacing) moves an element whose summed
      magnitudes it multiplies, plus (8·d + |μ|²/2)·ε times the summed
      magnitudes, the relative rounding of the sums and of the exponent's
      argument.  A relative bound between the two versions would need both
      to round subnormal numbers at the same points.

    Returns the counts beyond each rule, the largest share of the bound
    among normal elements, and among subnormal ones the most spacings and
    the largest share of their allowance, per version, and how far the
    allowance reaches past :func:`rounding_bound`: the largest relative
    part, (8·d + |μ|²/2) / (8·d) times the bound, and the largest
    |L| @ |U| spacings beside the fixed ``SUBNORMAL_SPACINGS``."""
    out = _no_findings()
    for o in range(0, mu_re.shape[0], _CHECK_CHUNK):
        rows = slice(o, o + _CHECK_CHUNK)
        part = _check_chunk([t[rows] for t in got], [t[rows] for t in want],
                            mu_re[rows], mu_im[rows], d)
        for k, v in part.items():
            out[k] = out[k] + v if k.startswith(("beyond", "subnormal")) \
                else max(out[k], v)
    return out


def _no_findings() -> dict:
    out = {"beyond_bound": 0, "beyond_spacings": 0, "subnormal_elements": 0,
           "of_bound": 0.0, "allowance_relative_of_bound": 0.0,
           "allowance_lu_spacings": 0.0}
    for v in ("kernel", "plain"):
        out[f"spacings_{v}"] = out[f"of_allowance_{v}"] = 0.0
    return out


def _check_chunk(got, want, mu_re, mu_im, d: int) -> dict:
    pref, lu = _summed_magnitudes(mu_re, mu_im, d)
    info = torch.finfo(mu_re.dtype)
    summed = pref[:, None, None] * lu
    bound = 8 * d * info.eps * summed
    step = info.smallest_normal * info.eps          # the least subnormal
    r2 = (mu_re.double() ** 2 + mu_im.double() ** 2)[:, None, None]
    allowed = ((SUBNORMAL_SPACINGS + lu) * step
               + (8 * d + r2 / 2) * info.eps * summed)
    # divide by tensors, never by the subnormal scalar: on the card a
    # division by a scalar multiplies by its reciprocal, which overflows
    steps = torch.full_like(lu, step)
    out = _no_findings()
    for g, w, x in zip(got, want, exact_values(mu_re, mu_im, d)):
        small = x.abs() < info.smallest_normal
        share = torch.where(small, 0.0, (g - w).abs().double() / bound)
        share = share.nan_to_num(0.0)
        out["beyond_bound"] += int((share > 1).sum())
        out["of_bound"] = max(out["of_bound"], share.max().item())
        out["subnormal_elements"] += int(small.sum())
        if small.any():
            rel = ((8 * d + r2 / 2) / (8 * d)).expand_as(small)[small]
            out["allowance_relative_of_bound"] = max(
                out["allowance_relative_of_bound"], rel.max().item())
            out["allowance_lu_spacings"] = max(
                out["allowance_lu_spacings"], lu[small].max().item())
        for v, t in (("kernel", g), ("plain", w)):
            dev = (t.double() - x).abs()
            k = torch.where(small, dev / steps, 0.0)
            share = torch.where(small, dev / allowed, 0.0)
            out["beyond_spacings"] += int((share > 1).sum())
            out[f"spacings_{v}"] = max(out[f"spacings_{v}"], k.max().item())
            out[f"of_allowance_{v}"] = max(out[f"of_allowance_{v}"],
                                           share.max().item())
    return out


def _check_d(d: int) -> None:
    if not 1 <= d <= MAX_D:
        raise ValueError(f"displacement_expm: d={d} outside 1..{MAX_D}")


def _check_batch(name: str, b: int) -> None:
    if not 1 <= b < 2 ** 31:
        raise ValueError(f"{name}: batch {b} outside the kernel's grid")


def _entry(name: str, table: dict, dtype) -> str:
    if dtype not in table:
        raise TypeError(f"{name}: dtype {dtype} not supported; have "
                        f"{sorted(str(k) for k in table)}")
    return table[dtype]


def displacement_expm(mu_re, mu_im, d: int):
    """The kernel: μ re/im (B,), both fp32 or both fp64 → (B, d, d) re/im
    planes as :func:`displacement_expm_plain`.  d ≤ 16.  A thread a sample;
    bound by the output bytes."""
    _check_d(d)
    if mu_re.device.type == "cpu":
        return displacement_expm_plain(mu_re, mu_im, d)
    name = "displacement_expm"
    dev, dt = mu_re.device, mu_re.dtype
    entry = _entry(name, _ENTRY, dt)
    _build.check_operands(name, dev, {"mu_re": (mu_re, dt),
                                      "mu_im": (mu_im, dt)})
    if mu_re.ndim != 1 or mu_im.shape != mu_re.shape:
        raise ValueError(f"{name}: expected μ re/im (B,); got "
                         f"{tuple(mu_re.shape)} and {tuple(mu_im.shape)}")
    b = mu_re.shape[0]
    _check_batch(name, b)
    out_re = torch.empty((b, d, d), dtype=dt, device=dev)
    out_im = torch.empty((b, d, d), dtype=dt, device=dev)
    _build.launch(entry, (mu_re, mu_im, horner_table(dt, dev),
                          coeff_table(MAX_D, dt, dev), out_re, out_im),
                  (b, d), dev, name, source="displacement_expm")
    _build.count_launch(LAUNCHES, name)
    return out_re, out_im


def displacement_expm_complex(mu, d: int):
    """The kernel on a complex μ (B,), complex64 or complex128 →
    (B, d, d) complex D(μ), written as the complex tensor's (re, im) pairs:
    no planes to join and no copies of μ's parts."""
    _check_d(d)
    if mu.device.type == "cpu":
        return displacement_expm_complex_plain(mu, d)
    name = "displacement_expm"
    dev, dt = mu.device, mu.dtype
    entry = _entry(name, _COMPLEX_ENTRY, dt)
    _build.check_operands(name, dev, {"mu": (mu, dt)})
    if mu.ndim != 1 or mu.is_conj():
        raise ValueError(f"{name}: expected μ (B,) complex without a "
                         f"conjugate bit; got {tuple(mu.shape)}")
    b = mu.shape[0]
    _check_batch(name, b)
    out = torch.empty((b, d, d), dtype=dt, device=dev)
    real = torch.view_as_real
    rdt = real(mu).dtype
    _build.launch(entry, (real(mu), horner_table(rdt, dev),
                          coeff_table(MAX_D, rdt, dev), real(out)), (b, d),
                  dev, name, source="displacement_expm")
    _build.count_launch(LAUNCHES, name)
    return out
