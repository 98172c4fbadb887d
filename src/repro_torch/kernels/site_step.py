"""Fused MPS site step: hand-written Hopper kernels beside their plain versions.

One site of Alg. 1 is contract → measure → normalise/cumsum/draw →
collapse (×λ for Born) → per-sample rescale.  The wrappers
:func:`site_step_linear` and :func:`site_step_born` launch the CUDA kernels
of ``csrc/site_step.cu`` (which replace the Pallas TPU kernels
``repro/kernels/site_step.py::site_step_linear`` / ``::site_step_born``;
that file's header says how the design differs and why).  Each wrapper
takes its plain version, :func:`site_step_linear_plain` /
:func:`site_step_born_plain`, only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.

Randomness stays outside: the caller passes the per-site uniforms ``u`` (N,)
drawn from the folded key, so the kernels and the plain versions consume
the same bits.

``LAUNCHES`` counts kernel launches per wrapper (one per call that reached
the card); ``reset_launches`` sets them to 0.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import precision
from repro_torch.core.precision import real_dtype_of
from repro_torch.kernels import _build

LAUNCHES = {"site_step_linear": 0, "site_step_born": 0}

_FUSED_SCALING = ("per_sample", "none")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def draw_from_uniform(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Alg. 1 lines 2-4 given the per-sample uniforms: normalise, cumsum,
    threshold draw.  probs (N, d) ≥ 0; u (N, 1) in [0, 1)."""
    probs = torch.clamp(probs, min=0.0)
    total = torch.sum(probs, dim=1, keepdim=True)
    # fully underflowed rows fall back to uniform (paper Fig. 6 failure mode)
    safe = torch.where(total > 0,
                       probs / torch.where(total > 0, total, 1.0),
                       torch.ones_like(probs) / probs.shape[1])
    cdf = torch.cumsum(safe, dim=1)
    return torch.sum((u > cdf).to(torch.int64), dim=1).clamp(
        0, probs.shape[1] - 1)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (op for op with the JAX package's xla cells)
# ---------------------------------------------------------------------------

def _site_step_plain(env, gamma, lam, u, *, semantics: str, scaling: str):
    temp = torch.einsum("nl,lrs->nrs", env, gamma)
    if semantics == "linear":
        probs = torch.einsum("nrs,r->ns", temp, lam)
    else:
        probs = torch.sum((temp * lam[None, :, None]).abs() ** 2, dim=1)
    samples = draw_from_uniform(probs, u[:, None])
    new_env = torch.take_along_dim(temp, samples[:, None, None], dim=2)[:, :, 0]
    if semantics == "born":
        new_env = new_env * lam[None, :]
    new_env, dlog = precision.rescale(new_env, mode=scaling)
    return new_env, samples, dlog


def site_step_linear_plain(env, gamma, lam, u, scaling: str = "per_sample"):
    """env (N, χl), Γ (χl, χr, d), Λ (χr), u (N,) → (env' (N, χr),
    samples (N,) int64, dlog (N,)); every scaling mode."""
    return _site_step_plain(env, gamma, lam, u, semantics="linear",
                            scaling=scaling)


def site_step_born_plain(env, gamma, lam, u, scaling: str = "per_sample"):
    """Born: env (N, χl) complex, Γ (χl, χr, d) complex, λ (χr) real,
    u (N,) real → (env' (N, χr) complex, samples (N,) int64, dlog (N,))."""
    return _site_step_plain(env, gamma, lam, u, semantics="born",
                            scaling=scaling)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_LINEAR_ENTRY = {torch.float64: "fastmps_site_step_linear_f64",
                 torch.float32: "fastmps_site_step_linear_f32"}
_BORN_ENTRY = {torch.complex128: "fastmps_site_step_born_c128",
               torch.complex64: "fastmps_site_step_born_c64"}


def _check_operands(env, gamma, lam, u, entries: dict, name: str):
    """Validate what the kernel takes; returns (n, χl, χr, d)."""
    if env.dtype not in entries:
        raise TypeError(f"{name}: env dtype {env.dtype} not supported; "
                        f"have {sorted(str(k) for k in entries)}")
    rdt = real_dtype_of(env.dtype)
    want = {"env": (env, env.dtype), "gamma": (gamma, env.dtype),
            "lam": (lam, rdt), "u": (u, rdt)}
    for arg, (t, dt) in want.items():
        if t.device != env.device:
            raise ValueError(f"{name}: {arg} is on {t.device}, env on "
                             f"{env.device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if env.ndim != 2 or gamma.ndim != 3:
        raise ValueError(f"{name}: expected env (N, χl) and Γ (χl, χr, d); "
                         f"got {tuple(env.shape)} and {tuple(gamma.shape)}")
    n, chi_l = env.shape
    chi_l2, chi_r, d = gamma.shape
    if chi_l2 != chi_l or lam.shape != (chi_r,) or u.shape != (n,):
        raise ValueError(f"{name}: shapes disagree: env {tuple(env.shape)}, "
                         f"Γ {tuple(gamma.shape)}, λ {tuple(lam.shape)}, "
                         f"u {tuple(u.shape)}")
    max_d = _build.library("site_step").fastmps_max_d()
    if not 1 <= d <= max_d:
        raise ValueError(f"{name}: d={d} outside the kernel's 1..{max_d}")
    if n < 1 or chi_l < 1 or chi_r < 1:
        raise ValueError(f"{name}: empty operand")
    if chi_r * d >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"{name}: sizes exceed the kernel's 32-bit indices")
    return n, chi_l, chi_r, d


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(entry: str, env, gamma, lam, u, scratch: list, n, chi_l, chi_r,
            d, scaling: str, name: str):
    """Launch one C entry: operands, outputs, then ``scratch`` buffers."""
    dev = env.device
    env_out = torch.empty((n, chi_r), dtype=env.dtype, device=dev)
    samples = torch.empty((n,), dtype=torch.int32, device=dev)
    dlog = torch.empty((n,), dtype=real_dtype_of(env.dtype), device=dev)
    fn = getattr(_build.library("site_step"), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(_ptr(t) for t in (env, gamma, lam, u, env_out, samples,
                                     dlog, *scratch)),
                 n, chi_l, chi_r, d, int(scaling == "per_sample"),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
    return env_out, samples.to(torch.int64), dlog


def _check_scaling(scaling: str, name: str) -> None:
    if scaling not in _FUSED_SCALING:
        raise ValueError(f"{name} cannot do scaling={scaling!r} (the max "
                         "crosses row tiles); rescale outside")


def site_step_linear(env, gamma, lam, u, scaling: str = "per_sample"):
    """Fused linear site step: env (N, χl), Γ (χl, χr, d), Λ (χr), u (N,),
    all fp32 or all fp64 → (env' (N, χr), samples (N,) int64, dlog (N,)).
    ``scaling`` is ``per_sample`` or ``none``."""
    _check_scaling(scaling, "site_step_linear")
    if env.device.type == "cpu":
        return site_step_linear_plain(env, gamma, lam, u, scaling=scaling)
    n, chi_l, chi_r, d = _check_operands(env, gamma, lam, u, _LINEAR_ENTRY,
                                         "site_step_linear")
    dev = env.device
    scratch = [torch.empty((chi_l, d), dtype=env.dtype, device=dev),   # W
               torch.empty((n,), dtype=torch.int32, device=dev),       # perm
               torch.empty((3 * d + 1,), dtype=torch.int32, device=dev)]
    return _launch(_LINEAR_ENTRY[env.dtype], env, gamma, lam, u, scratch, n,
                   chi_l, chi_r, d, scaling, "site_step_linear")


def site_step_born(env, gamma, lam, u, scaling: str = "per_sample"):
    """Fused Born site step: env (N, χl) and Γ (χl, χr, d) complex64/128,
    λ (χr) and u (N,) of the matching real dtype → (env' (N, χr) complex,
    samples (N,) int64, dlog (N,) real).  ``scaling``: per_sample | none."""
    _check_scaling(scaling, "site_step_born")
    if env.device.type == "cpu":
        return site_step_born_plain(env, gamma, lam, u, scaling=scaling)
    n, chi_l, chi_r, d = _check_operands(env, gamma, lam, u, _BORN_ENTRY,
                                         "site_step_born")
    temp = torch.empty((n, chi_r, d), dtype=env.dtype, device=env.device)
    return _launch(_BORN_ENTRY[env.dtype], env, gamma, lam, u, [temp], n,
                   chi_l, chi_r, d, scaling, "site_step_born")
