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

:func:`measure_probs` (with its plain version :func:`measure_first_plain`)
is the tensor-parallel measure-first stage: it replaces the Pallas
``repro/kernels/site_step.py::measure_probs``.

Randomness stays outside: the caller passes the per-site uniforms ``u`` (N,)
drawn from the folded key, so the kernels and the plain versions consume
the same bits.

``LAUNCHES`` counts kernel launches per wrapper (one per call that reached
the card); ``reset_launches`` sets them to 0.
"""
from __future__ import annotations

import torch

from repro_torch.core import precision
from repro_torch.core.precision import real_dtype_of
from repro_torch.kernels import _build

LAUNCHES = {"site_step_linear": 0, "site_step_born": 0,
            "measure_probs": 0}

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


def measure_first_plain(env, w):
    """The measure-first partial probs of one bond shard: env (N, L) · W (L, d)
    → (N, d); the caller sums them over the TP group."""
    return env @ w


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_LINEAR_ENTRY = {torch.float64: "fastmps_site_step_linear_f64",
                 torch.float32: "fastmps_site_step_linear_f32"}
_BORN_ENTRY = {torch.complex128: "fastmps_site_step_born_c128",
               torch.complex64: "fastmps_site_step_born_c64"}
_MEASURE_ENTRY = {torch.float64: "fastmps_measure_probs_f64",
                  torch.float32: "fastmps_measure_probs_f32"}


def supported(env, entries: dict, name: str) -> str:
    """The C entry for env's dtype; raises for a dtype the kernel lacks."""
    if env.dtype not in entries:
        raise TypeError(f"{name}: env dtype {env.dtype} not supported; "
                        f"have {sorted(str(k) for k in entries)}")
    return entries[env.dtype]


def _check_operands(env, gamma, lam, u, entries: dict, name: str):
    """Validate what the kernel takes; returns (n, χl, χr, d)."""
    supported(env, entries, name)
    rdt = real_dtype_of(env.dtype)
    _build.check_operands(name, env.device, {
        "env": (env, env.dtype), "gamma": (gamma, env.dtype),
        "lam": (lam, rdt), "u": (u, rdt)})
    if env.ndim != 2 or gamma.ndim != 3:
        raise ValueError(f"{name}: expected env (N, χl) and Γ (χl, χr, d); "
                         f"got {tuple(env.shape)} and {tuple(gamma.shape)}")
    n, chi_l = env.shape
    chi_l2, chi_r, d = gamma.shape
    if chi_l2 != chi_l or lam.shape != (chi_r,) or u.shape != (n,):
        raise ValueError(f"{name}: shapes disagree: env {tuple(env.shape)}, "
                         f"Γ {tuple(gamma.shape)}, λ {tuple(lam.shape)}, "
                         f"u {tuple(u.shape)}")
    _build.check_sizes(name, d, n, chi_l, chi_r * d)
    return n, chi_l, chi_r, d


def _launch(entry: str, env, gamma, lam, u, scratch: list, n, chi_l, chi_r,
            d, scaling: str, name: str):
    """Launch one site-step entry: operands, outputs, then ``scratch``."""
    dev = env.device
    env_out = torch.empty((n, chi_r), dtype=env.dtype, device=dev)
    samples = torch.empty((n,), dtype=torch.int32, device=dev)
    dlog = torch.empty((n,), dtype=real_dtype_of(env.dtype), device=dev)
    _build.launch(entry, (env, gamma, lam, u, env_out, samples, dlog,
                          *scratch),
                  (n, chi_l, chi_r, d, int(scaling == "per_sample")), dev,
                  name)
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


def measure_probs(env, w):
    """The tp-3 measure-first partial probs (replaces the Pallas
    ``repro/kernels/site_step.py::measure_probs``): env (N, L) · W (L, d),
    both fp32 or both fp64 → (N, d).  One block per row sums its L terms in
    a fixed order; bound by env's bytes."""
    if env.device.type == "cpu":
        return measure_first_plain(env, w)
    name = "measure_probs"
    entry = supported(env, _MEASURE_ENTRY, name)
    _build.check_operands(name, env.device, {"env": (env, env.dtype),
                                             "w": (w, env.dtype)})
    if env.ndim != 2 or w.ndim != 2 or w.shape[0] != env.shape[1]:
        raise ValueError(f"{name}: expected env (N, L) and W (L, d); got "
                         f"{tuple(env.shape)} and {tuple(w.shape)}")
    (n, chi_l), d = env.shape, w.shape[1]
    _build.check_sizes(name, d, n, chi_l, chi_l * d)
    probs = torch.empty((n, d), dtype=env.dtype, device=env.device)
    _build.launch(entry, (env, w, probs), (n, chi_l, d), env.device, name)
    LAUNCHES[name] += 1
    return probs
