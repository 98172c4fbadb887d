"""Sample-selected collapse for the measure-first TP schedule (tp-3).

By associativity of Alg. 1's linear measurement, ``probs = env @ W`` with
``W[l, s] = Σ_r Γ[l, r, s]·Λ[r]`` (:func:`measure_weights`), so the
(N, χ, d) temp is never needed to draw.  After the draw the new environment
is ``env'[n, r] = Σ_l env[n, l]·Γ[l, r, s_n]``.

:func:`collapse_select` launches the CUDA kernel of ``csrc/site_step.cu``
(which replaces the Pallas TPU kernel
``repro/kernels/collapse_select.py::collapse_select``): a stable counting sort
of the rows by outcome, then one GEMM grouped by outcome — 1/d of the flops
of the TPU kernel's d masked GEMMs.  It takes its plain version,
:func:`collapse_select_plain` (the d masked GEMMs, op for op with the JAX
package's ``collapse`` xla cell), only for tensors on the CPU.

``compute_dtype=torch.bfloat16`` rounds env and Γ to bf16 and sums in
fp32 on the tensor cores (the bf16 site step's collapse on ``wgmma``, fed
by TMA from bf16 operands it writes into :func:`bf16_scratch`: env in the
bucket sort's order and Γ's planes); env' is then fp32 whatever env's
dtype, as the JAX package's ``collapse`` cell returns it.

``LAUNCHES`` counts kernel launches (the bf16 entry apart);
``reset_launches`` sets them to 0.
"""
from __future__ import annotations

import torch

from repro_torch.core import precision
from repro_torch.kernels import _build
from repro_torch.kernels.site_step import (_BF16, _F32, _F64,
                                           check_compute_dtype, padded,
                                           supported)

LAUNCHES = {"collapse_select": 0, "collapse_select_bf16": 0}

_ENTRY = {(_F64, _F64): "fastmps_collapse_select_f64",
          (_F32, _F32): "fastmps_collapse_select_f32"}
_BF16_ENTRY = {(_F32, _F32): "fastmps_collapse_select_bf16_f32_f32",
               (_F32, _BF16): "fastmps_collapse_select_bf16_f32_bf16",
               (_F64, _F64): "fastmps_collapse_select_bf16_f64_f64"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def measure_weights(gamma, lam):
    """W[l, s] = Σ_r Γ[l, r, s]·Λ[r] — the per-site measure-first operator."""
    return torch.einsum("lrs,r->ls", gamma, lam)


def collapse_select_plain(env, gamma, samples, compute_dtype=None):
    """env (N, L), Γ (L, R, d), samples (N,) → env' (N, R) as d masked
    GEMMs; a row whose outcome is outside [0, d) comes out zero.  Under
    ``compute_dtype`` each GEMM takes inputs rounded to it and sums in
    fp32 (the JAX package's ``collapse`` cell)."""
    acc = None
    for s in range(gamma.shape[2]):
        mask = (samples == s).to(env.dtype)[:, None]
        if compute_dtype is None:
            dt = torch.promote_types(env.dtype, gamma.dtype)
            part = (env * mask).to(dt) @ gamma[:, :, s].to(dt)
        else:
            part = (precision.rounded(env * mask, compute_dtype)
                    @ precision.rounded(gamma[:, :, s], compute_dtype))
        acc = part if acc is None else acc + part
    return acc


def collapse_select(env, gamma, samples, compute_dtype=None):
    """The kernel → env' (N, R) as :func:`collapse_select_plain`, samples
    (N,) integers.  env and Γ both fp32 or both fp64, bound by fp64
    operations (2·N·L·R) at the full width; with
    ``compute_dtype=torch.bfloat16`` env and Γ fp32, env fp32 with a bf16
    Γ, or both fp64, on the bf16 tensor cores, env' in fp32."""
    name = "collapse_select"
    check_compute_dtype(compute_dtype, name)
    if env.device.type == "cpu":
        return collapse_select_plain(env, gamma, samples, compute_dtype)
    if compute_dtype is None:
        entry = supported(_ENTRY, name, env, gamma)
        out_dtype = env.dtype
    else:
        entry = supported(_BF16_ENTRY, name + " (bf16 inputs)", env, gamma)
        name, out_dtype = name + "_bf16", torch.float32
    if samples.dtype.is_floating_point or samples.dtype.is_complex:
        raise TypeError(f"{name}: samples must be integers, got "
                        f"{samples.dtype}")
    s32 = samples.to(torch.int32).contiguous()
    _build.check_operands(name, env.device, {
        "env": (env, env.dtype), "gamma": (gamma, gamma.dtype),
        "samples": (s32, torch.int32)})
    if (env.ndim != 2 or gamma.ndim != 3 or gamma.shape[0] != env.shape[1]
            or samples.shape != env.shape[:1]):
        raise ValueError(f"{name}: expected env (N, L), Γ (L, R, d), "
                         f"samples (N,); got {tuple(env.shape)}, "
                         f"{tuple(gamma.shape)}, {tuple(samples.shape)}")
    (n, chi_l), (chi_r, d) = env.shape, gamma.shape[1:]
    _build.check_sizes(name, d, n, chi_l, chi_r * d)
    dev = env.device
    out = torch.empty((n, chi_r), dtype=out_dtype, device=dev)
    perm = torch.empty((n,), dtype=torch.int32, device=dev)
    meta = torch.empty((3 * d + 1,), dtype=torch.int32, device=dev)
    scratch = () if compute_dtype is None else bf16_scratch(n, chi_l, chi_r,
                                                            d, dev)
    _build.launch(entry, (env, gamma, s32, out, perm, meta, *scratch),
                  (n, chi_l, chi_r, d), dev, name)
    _build.count_launch(LAUNCHES, name)
    return out


def bf16_scratch(n, chi_l, chi_r, d, device):
    """The bf16 entry's operands to write, in its C entry's order: env
    rounded in bucket order (N, padded(χl)) and Γ's bf16 planes (d, χl,
    padded(χr)); 205 MB at N = 1024, 2500 → 10⁴, d = 4."""
    return (torch.empty((n, padded(chi_l)), dtype=torch.bfloat16,
                        device=device),
            torch.empty((d, chi_l, padded(chi_r)), dtype=torch.bfloat16,
                        device=device))
