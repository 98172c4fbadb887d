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

``compute_dtype=torch.bfloat16`` (the JAX package's ``mxu_bf16`` and
``store_bf16`` tiers, linear only) rounds the GEMM inputs to bf16 and sums
in fp32, as the Pallas kernels' ``compute_dtype`` does; Γ may then be
stored in bf16 beside an fp32 environment.  Its kernels are the bf16
tensor-core entries of ``csrc/site_step.cu``, counted apart (``*_bf16``);
the site step's grouped collapse runs on the wgmma kernel from bf16
operands that the entry prepares in scratch the wrapper allocates: env in
bucket order and Γ's planes, whose plain versions are
:func:`bf16_rows_plain` and :func:`bf16_planes_plain`.

Randomness stays outside: the caller passes the per-site uniforms ``u`` (N,)
drawn from the folded key, so the kernels and the plain versions consume
the same bits.

``LAUNCHES`` counts kernel launches per wrapper and entry (one per call
that reached the card); ``reset_launches`` sets them to 0.
"""
from __future__ import annotations

import torch

from repro_torch.core import precision
from repro_torch.core.precision import real_dtype_of
from repro_torch.kernels import _build

LAUNCHES = {"site_step_linear": 0, "site_step_linear_bf16": 0,
            "site_step_born": 0, "measure_probs": 0,
            "measure_probs_bf16": 0}

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

def check_compute_dtype(compute_dtype, name: str) -> None:
    """The kernels take bf16 GEMM inputs or the operands' own dtype."""
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"{name}: compute_dtype={compute_dtype} is not a "
                         "tier of the port; use None or torch.bfloat16")


def contract_plain(env, gamma, compute_dtype=None):
    """temp[n, r, s] = Σ_l env[n, l]·Γ[l, r, s] as the JAX package's
    ``_contract_site`` and ``contract_parallel`` compute it: under
    ``compute_dtype`` both operands rounded to it and summed in fp32, then
    cast to env's dtype; without, in the operands' promoted dtype."""
    if compute_dtype is None:
        dt = torch.promote_types(env.dtype, gamma.dtype)
        return torch.einsum("nl,lrs->nrs", env.to(dt), gamma.to(dt))
    chi_l, chi_r, d = gamma.shape
    temp = (precision.rounded(env, compute_dtype)
            @ precision.rounded(gamma.reshape(chi_l, chi_r * d),
                                compute_dtype))
    return temp.reshape(env.shape[0], chi_r, d).to(env.dtype)


def linear_probs_plain(temp, lam):
    """probs[n, s] = Σ_r temp[n, r, s]·Λ[r] in the promoted dtype (Λ is
    never rounded)."""
    dt = torch.promote_types(temp.dtype, lam.dtype)
    return torch.einsum("nrs,r->ns", temp.to(dt), lam.to(dt))


def _site_step_plain(env, gamma, lam, u, *, semantics: str, scaling: str,
                     compute_dtype=None):
    linear = semantics == "linear"
    temp = contract_plain(env, gamma, compute_dtype if linear else None)
    if linear:
        probs = linear_probs_plain(temp, lam)
    else:
        probs = torch.sum((temp * lam[None, :, None]).abs() ** 2, dim=1)
    samples = draw_from_uniform(probs, u[:, None])
    new_env = torch.take_along_dim(temp, samples[:, None, None], dim=2)[:, :, 0]
    if semantics == "born":
        new_env = new_env * lam[None, :]
    new_env, dlog = precision.rescale(new_env, mode=scaling)
    return new_env, samples, dlog


def site_step_linear_plain(env, gamma, lam, u, scaling: str = "per_sample",
                           compute_dtype=None):
    """env (N, χl), Γ (χl, χr, d), Λ (χr), u (N,) → (env' (N, χr),
    samples (N,) int64, dlog (N,)); every scaling mode.  With
    ``compute_dtype`` the contraction takes bf16-rounded inputs and sums in
    fp32 (:func:`contract_plain`)."""
    return _site_step_plain(env, gamma, lam, u, semantics="linear",
                            scaling=scaling, compute_dtype=compute_dtype)


def site_step_born_plain(env, gamma, lam, u, scaling: str = "per_sample"):
    """Born: env (N, χl) complex, Γ (χl, χr, d) complex, λ (χr) real,
    u (N,) real → (env' (N, χr) complex, samples (N,) int64, dlog (N,))."""
    return _site_step_plain(env, gamma, lam, u, semantics="born",
                            scaling=scaling)


def measure_first_plain(env, w, compute_dtype=None):
    """The measure-first partial probs of one bond shard: env (N, L) · W (L, d)
    → (N, d); the caller sums them over the TP group.  Under
    ``compute_dtype`` both are rounded to it and summed in fp32 (an fp32
    result, as the JAX package's ``measure`` cell)."""
    if compute_dtype is None:
        return env @ w
    return precision.rounded(env, compute_dtype) @ precision.rounded(
        w, compute_dtype)


def padded(k: int) -> int:
    """``k`` rounded up to a whole 16 bytes of bf16: a row stride TMA
    takes."""
    return -(-k // 8) * 8


def bucket_plain(samples, d: int):
    """The rows in the bucket sort's order, as its kernel writes ``perm``:
    stable by outcome, then the rows whose outcome is outside [0, d) (they
    join no group), in order; int32."""
    key = torch.where((samples >= 0) & (samples < d), samples, d)
    return torch.sort(key, stable=True).indices.to(torch.int32)


def bf16_rows_plain(x, perm=None):
    """The bf16 env (or Γ) operand of the wgmma GEMM as the kernels'
    preparation pass writes it: (rows, K) → (rows, ``padded(K)``) bf16, row
    m = ``x[perm[m]]`` (the collapse's bucket order) or ``x[m]``, rounded as
    :func:`precision.rounded` rounds (fp64 through fp32), zeros past K."""
    if perm is not None:
        x = x[perm.long()]
    rows, k = x.shape
    out = torch.zeros((rows, padded(k)), dtype=torch.bfloat16,
                      device=x.device)
    out[:, :k] = precision.rounded(x, torch.bfloat16, torch.bfloat16)
    return out


def bf16_planes_plain(gamma):
    """Γ's bf16 planes as the bf16 site step's W pass writes them: Γ (L, R,
    d) → P (d, L, ``padded(R)``), P[s, l, r] = bf16(Γ[l, r, s]), zeros past
    R."""
    chi_l, chi_r, d = gamma.shape
    out = torch.zeros((d, chi_l, padded(chi_r)), dtype=torch.bfloat16,
                      device=gamma.device)
    out[:, :, :chi_r] = precision.rounded(gamma, torch.bfloat16,
                                          torch.bfloat16).permute(2, 0, 1)
    return out


def bf16_gemm_bound(a, b):
    """Elementwise bound (fp64) on |kernel − plain| for a (M, K) · b (K, N)
    on bf16-rounded inputs with fp32 sums.  The K products are exact in
    fp32; each of the K − 1 additions rounds by at most 2⁻²⁴ of a partial
    sum no larger than Σ_k |a||b|, in either version, so two summation
    orders differ by at most 2·K·2⁻²⁴·Σ_k |a||b| (as
    ``flash_attention.rounding_bound`` counts its fp32 sums)."""
    ra = precision.rounded(a, torch.bfloat16, torch.float64).abs()
    rb = precision.rounded(b, torch.bfloat16, torch.float64).abs()
    return 2 * a.shape[-1] * 2.0 ** -24 * (ra @ rb)


def site_step_bf16_bounds(env, gamma, lam):
    """Elementwise bounds (fp64) on |kernel − plain| of the bf16-input
    linear site step: (probs (N, d), temp (N, R, d) before the rescale).

    The kernel measures first, Σ_l bf16(env)·W with W = Σ_r bf16(Γ)·Λ; the
    plain version sums Σ_r [Σ_l bf16(env)·bf16(Γ)]·Λ.  Each adds L + R
    rounded terms (in fp32, or fp64 where env is fp64), so the two differ
    by at most 2·(L + R)·2⁻²⁴·Σ_l Σ_r |env||Γ|Λ.  temp is
    :func:`bf16_gemm_bound`."""
    chi_l, chi_r, d = gamma.shape
    ra = precision.rounded(env, torch.bfloat16, torch.float64).abs()
    rg = precision.rounded(gamma, torch.bfloat16, torch.float64).abs()
    probs = 2 * (chi_l + chi_r) * 2.0 ** -24 * (
        ra @ torch.einsum("lrs,r->ls", rg, lam.double().abs()))
    temp = bf16_gemm_bound(env, gamma.reshape(chi_l, chi_r * d))
    return probs, temp.reshape(env.shape[0], chi_r, d)


def draw_margin(probs, u):
    """Per row, how far the uniform lies from flipping the draw: the least
    |u − cdf_k| over the inner CDF boundaries (k < d − 1); inf for d = 1.
    A draw that differs between two versions is sound when this margin is
    within the CDF's rounding bound."""
    p = probs.double().clamp(min=0.0)
    cdf = torch.cumsum(p / p.sum(dim=1, keepdim=True), dim=1)[:, :-1]
    if cdf.shape[1] == 0:
        return torch.full((p.shape[0],), float("inf"), dtype=torch.float64,
                          device=p.device)
    return (u.double()[:, None] - cdf).abs().amin(dim=1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_F64, _F32, _BF16 = torch.float64, torch.float32, torch.bfloat16
# C entries by the dtypes of (env, Γ) (measure: (env, W)); the bf16 tables
# take the operands that the mxu_bf16 (fp32, fp32), store_bf16 (fp32, bf16)
# and fp64-chain (fp64, fp64) walks hand them
_LINEAR_ENTRY = {(_F64, _F64): "fastmps_site_step_linear_f64",
                 (_F32, _F32): "fastmps_site_step_linear_f32"}
_LINEAR_BF16_ENTRY = {
    (_F32, _F32): "fastmps_site_step_linear_bf16_f32_f32",
    (_F32, _BF16): "fastmps_site_step_linear_bf16_f32_bf16",
    (_F64, _F64): "fastmps_site_step_linear_bf16_f64_f64"}
_BORN_ENTRY = {(torch.complex128, torch.complex128):
               "fastmps_site_step_born_c128",
               (torch.complex64, torch.complex64):
               "fastmps_site_step_born_c64"}
_MEASURE_ENTRY = {(_F64, _F64): "fastmps_measure_probs_f64",
                  (_F32, _F32): "fastmps_measure_probs_f32"}
_MEASURE_BF16_ENTRY = {(_F64, _F64): "fastmps_measure_probs_bf16_f64",
                       (_F32, _F32): "fastmps_measure_probs_bf16_f32"}


def supported(entries: dict, name: str, *operands) -> str:
    """The C entry for the operands' dtypes; raises for a combination the
    kernel lacks."""
    key = tuple(t.dtype for t in operands)
    if key not in entries:
        have = sorted("/".join(str(d) for d in k) for k in entries)
        raise TypeError(f"{name}: operand dtypes "
                        f"{'/'.join(str(d) for d in key)} not supported; "
                        f"have {have}")
    return entries[key]


def _check_operands(env, gamma, lam, u, name: str):
    """Validate placement, contiguity and shapes (the dtypes are the
    entry's); returns (n, χl, χr, d).  λ and u are env's real dtype."""
    rdt = real_dtype_of(env.dtype)
    _build.check_operands(name, env.device, {
        "env": (env, env.dtype), "gamma": (gamma, gamma.dtype),
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
    """Launch one site-step entry: operands, outputs, then ``scratch``;
    counts the launch under ``name``."""
    dev = env.device
    env_out = torch.empty((n, chi_r), dtype=env.dtype, device=dev)
    samples = torch.empty((n,), dtype=torch.int32, device=dev)
    dlog = torch.empty((n,), dtype=real_dtype_of(env.dtype), device=dev)
    _build.launch(entry, (env, gamma, lam, u, env_out, samples, dlog,
                          *scratch),
                  (n, chi_l, chi_r, d, int(scaling == "per_sample")), dev,
                  name)
    _build.count_launch(LAUNCHES, name)
    return env_out, samples.to(torch.int64), dlog


def _check_scaling(scaling: str, name: str) -> None:
    if scaling not in _FUSED_SCALING:
        raise ValueError(f"{name} cannot do scaling={scaling!r} (the max "
                         "crosses row tiles); rescale outside")


def site_step_linear(env, gamma, lam, u, scaling: str = "per_sample",
                     compute_dtype=None):
    """Fused linear site step: env (N, χl), Γ (χl, χr, d), Λ (χr), u (N,)
    → (env' (N, χr), samples (N,) int64, dlog (N,)).  ``scaling`` is
    ``per_sample`` or ``none``.  All fp32 or all fp64; with
    ``compute_dtype=torch.bfloat16`` (Λ and u in env's dtype) env and Γ
    fp32, env fp32 with a bf16 Γ, or both fp64."""
    name = "site_step_linear"
    _check_scaling(scaling, name)
    check_compute_dtype(compute_dtype, name)
    if env.device.type == "cpu":
        return site_step_linear_plain(env, gamma, lam, u, scaling=scaling,
                                      compute_dtype=compute_dtype)
    if compute_dtype is None:
        entry = supported(_LINEAR_ENTRY, name, env, gamma)
    else:
        entry = supported(_LINEAR_BF16_ENTRY, name + " (bf16 inputs)", env,
                          gamma)
        name += "_bf16"
    n, chi_l, chi_r, d = _check_operands(env, gamma, lam, u, name)
    return _launch(entry, env, gamma, lam, u,
                   linear_scratch(n, chi_l, chi_r, d, env.dtype, env.device,
                                  compute_dtype),
                   n, chi_l, chi_r, d, scaling, name)


def linear_scratch(n, chi_l, chi_r, d, dtype, device, compute_dtype=None):
    """The linear step's scratch, in its C entry's order: W (χl, d), perm
    (N,) and the bucket sort's meta (3d + 1,); under bf16 inputs also the
    bf16 env in bucket order (N, padded(χl)) and Γ's bf16 planes (d, χl,
    padded(χr)), the wgmma collapse's operands (0.8 GB at χ = 10⁴, d = 4)."""
    scratch = [torch.empty((chi_l, d), dtype=dtype, device=device),
               torch.empty((n,), dtype=torch.int32, device=device),
               torch.empty((3 * d + 1,), dtype=torch.int32, device=device)]
    if compute_dtype is not None:
        scratch += [torch.empty((n, padded(chi_l)), dtype=torch.bfloat16,
                                device=device),
                    torch.empty((d, chi_l, padded(chi_r)),
                                dtype=torch.bfloat16, device=device)]
    return scratch


def site_step_born(env, gamma, lam, u, scaling: str = "per_sample"):
    """Fused Born site step: env (N, χl) and Γ (χl, χr, d) complex64/128,
    λ (χr) and u (N,) of the matching real dtype → (env' (N, χr) complex,
    samples (N,) int64, dlog (N,) real).  ``scaling``: per_sample | none."""
    _check_scaling(scaling, "site_step_born")
    if env.device.type == "cpu":
        return site_step_born_plain(env, gamma, lam, u, scaling=scaling)
    entry = supported(_BORN_ENTRY, "site_step_born", env, gamma)
    n, chi_l, chi_r, d = _check_operands(env, gamma, lam, u, "site_step_born")
    temp = torch.empty((n, chi_r, d), dtype=env.dtype, device=env.device)
    return _launch(entry, env, gamma, lam, u, [temp], n, chi_l, chi_r, d,
                   scaling, "site_step_born")


def measure_probs(env, w, compute_dtype=None):
    """The tp-3 measure-first partial probs (replaces the Pallas
    ``repro/kernels/site_step.py::measure_probs``): env (N, L) · W (L, d),
    both fp32 or both fp64 → (N, d) in their dtype; with
    ``compute_dtype=torch.bfloat16`` both rounded to bf16 and summed in
    fp32 → (N, d) fp32.  A block takes many rows and stages W in shared
    memory once for all of them; every sum is taken in a fixed order.
    Bound by env's bytes."""
    name = "measure_probs"
    check_compute_dtype(compute_dtype, name)
    if env.device.type == "cpu":
        return measure_first_plain(env, w, compute_dtype)
    if compute_dtype is None:
        entry = supported(_MEASURE_ENTRY, name, env, w)
        out_dtype = env.dtype
    else:
        entry = supported(_MEASURE_BF16_ENTRY, name + " (bf16 inputs)", env,
                          w)
        name, out_dtype = name + "_bf16", torch.float32
    _build.check_operands(name, env.device, {"env": (env, env.dtype),
                                             "w": (w, w.dtype)})
    if env.ndim != 2 or w.ndim != 2 or w.shape[0] != env.shape[1]:
        raise ValueError(f"{name}: expected env (N, L) and W (L, d); got "
                         f"{tuple(env.shape)} and {tuple(w.shape)}")
    (n, chi_l), d = env.shape, w.shape[1]
    _build.check_sizes(name, d, n, chi_l, chi_l * d)
    probs = torch.empty((n, d), dtype=out_dtype, device=env.device)
    _build.launch(entry, (env, w, probs), (n, chi_l, d), env.device, name)
    _build.count_launch(LAUNCHES, name)
    return probs
