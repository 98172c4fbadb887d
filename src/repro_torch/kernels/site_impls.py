"""Registered implementations behind ``kernels/dispatch.py``.

Stage signatures (semantics is part of the registry key):

* ``site_step(env, gamma, lam, u, *, scaling, compute_dtype)``
  → ``(env', samples, dlog)`` with u (N, 1)
* ``contract_measure(env, gamma, lam, *, semantics, compute_dtype)``
  → ``(temp, probs)`` (the split-K TP schedules; ``cuda`` is linear only,
  as the JAX package's Pallas cell)
* ``measure(env, w, *, compute_dtype)`` → partial probs ``(N, d)`` (linear)
* ``collapse(env, gamma, samples, *, compute_dtype)`` → ``env' (N, R)``
  (linear)

The ``torch`` cells are the plain versions beside the kernels; the ``cuda``
cells launch the Hopper kernels.  The site-step cells rescale ``global``
outside, as the JAX package's Pallas cells do (the global max crosses row
tiles).
"""
from __future__ import annotations

import torch

from repro_torch.core import precision
from repro_torch.core.precision import real_dtype_of
from repro_torch.kernels import collapse_select as CS
from repro_torch.kernels import contract_measure as CM
from repro_torch.kernels.dispatch import register_site_op
from repro_torch.kernels.site_step import (  # noqa: F401  (draw re-exported)
    contract_plain, draw_from_uniform, linear_probs_plain,
    measure_first_plain, measure_probs, site_step_born, site_step_born_plain,
    site_step_linear, site_step_linear_plain)


def _on_card(env, stage: str) -> None:
    if env.device.type != "cuda":
        raise ValueError(f"the cuda {stage} cell needs tensors on a CUDA "
                         f"device; got {env.device}")


def site_probs_dtype(env, gamma, lam, semantics: str,
                     compute_dtype) -> torch.dtype:
    """The dtype the measurement probabilities (and hence the inverse-CDF
    uniforms) come out as, as the JAX package's ``site_probs_dtype``
    derives it: temp's dtype (env's under ``compute_dtype``, which applies
    to linear only; else the operands' promoted one) promoted with Λ, made
    real for Born.  Callers pre-draw ``u`` with exactly this dtype so every
    backend consumes the same bits."""
    if compute_dtype is not None and semantics == "linear":
        temp = env.dtype
    else:
        temp = torch.promote_types(env.dtype, gamma.dtype)
    dt = torch.promote_types(temp, lam.dtype)
    return real_dtype_of(dt) if semantics == "born" else dt


# ---------------------------------------------------------------------------
# site_step — the whole Alg. 1 pipeline for one site.  ``compute_dtype``
# applies to linear only: the Born cells run in the amplitudes' dtype, as
# the JAX package's do.
# ---------------------------------------------------------------------------

@register_site_op("site_step", "linear", "torch")
def site_step_linear_torch(env, gamma, lam, u, *, scaling, compute_dtype):
    return site_step_linear_plain(env, gamma, lam, u[:, 0], scaling=scaling,
                                  compute_dtype=compute_dtype)


@register_site_op("site_step", "born", "torch")
def site_step_born_torch(env, gamma, lam, u, *, scaling, compute_dtype):
    return site_step_born_plain(env, gamma, lam, u[:, 0], scaling=scaling)


def _as_env(x, env):
    """A real operand (Λ, u) in env's real dtype.  A store keeps Λ in the
    dtype it was written in, so an fp32 walk of a store written in fp64
    gets an fp64 Λ, and its uniforms come in the probabilities' promoted
    dtype; the Pallas kernels cast Λ to their fp32 accumulation and compare
    their fp32 CDF with the fp64 uniform, which the fp32 uniform here
    differs from only within half an fp32 spacing of a CDF boundary."""
    return x.to(real_dtype_of(env.dtype))


def _site_step_cuda(kernel, env, gamma, lam, u, scaling, **kw):
    _on_card(env, "site-step")
    fused = scaling if scaling in ("per_sample", "none") else "none"
    env2, samples, dlog = kernel(env, gamma, _as_env(lam, env),
                                 _as_env(u[:, 0], env), scaling=fused, **kw)
    if scaling == "global":
        env2, dlog = precision.rescale(env2, "global")
    return env2, samples, dlog


@register_site_op("site_step", "linear", "cuda")
def site_step_linear_cuda(env, gamma, lam, u, *, scaling, compute_dtype):
    return _site_step_cuda(site_step_linear, env, gamma, lam, u, scaling,
                           compute_dtype=compute_dtype)


@register_site_op("site_step", "born", "cuda")
def site_step_born_cuda(env, gamma, lam, u, *, scaling, compute_dtype):
    return _site_step_cuda(site_step_born, env, gamma, lam, u, scaling)


# ---------------------------------------------------------------------------
# contract_measure — the split-K TP schedules' (temp, probs) pair
# ---------------------------------------------------------------------------

def measure_probs_plain(temp, lam, semantics: str):
    """Alg. 1 line 1 for either semantics: linear ``temp·Λ``, Born
    ``Σ_r |temp λ|²`` (shared by the TP schedules and the [19] baseline)."""
    if semantics == "linear":
        return linear_probs_plain(temp, lam)
    return torch.sum((temp * lam[None, :, None]).abs() ** 2, dim=1)


def contract_parallel(env, gamma, compute_dtype):
    """The segment runner's contraction ``temp[n,r,s] = Σ_l env·Γ`` — the
    torch cells and the Born split-K paths share this one implementation.
    The JAX package applies ``compute_dtype`` here to Born too, casting the
    complex env to bf16, which drops its imaginary part; the port refuses
    that instead of reproducing it."""
    if compute_dtype is not None and env.is_complex():
        raise ValueError(
            "compute_dtype applies to linear chains: the Born TP schedules "
            "would round complex amplitudes to a real bf16, dropping their "
            "imaginary part (as the JAX package does)")
    return contract_plain(env, gamma, compute_dtype)


def _contract_measure_torch(env, gamma, lam, *, semantics, compute_dtype):
    temp = contract_parallel(env, gamma, compute_dtype)
    return temp, measure_probs_plain(temp, lam, semantics)


register_site_op("contract_measure", "linear", "torch")(
    _contract_measure_torch)
register_site_op("contract_measure", "born", "torch")(_contract_measure_torch)


@register_site_op("contract_measure", "linear", "cuda")
def contract_measure_cuda(env, gamma, lam, *, semantics, compute_dtype):
    del semantics                      # the registry key says linear
    _on_card(env, "contract_measure")
    return CM.contract_measure(env, gamma, _as_env(lam, env), compute_dtype)


# ---------------------------------------------------------------------------
# measure — the tp-3 measure-first partial probs (linear only)
# ---------------------------------------------------------------------------

def _promoted(env, w):
    """env and W in their promoted dtype (W is built in fp32, as in the JAX
    package, and meets an fp64 env by promotion there)."""
    dt = torch.promote_types(env.dtype, w.dtype)
    return env.to(dt), w.to(dt)


@register_site_op("measure", "linear", "torch")
def measure_torch(env, w, *, compute_dtype):
    return measure_first_plain(*_promoted(env, w), compute_dtype)


@register_site_op("measure", "linear", "cuda")
def measure_cuda(env, w, *, compute_dtype):
    _on_card(env, "measure")
    return measure_probs(*_promoted(env, w), compute_dtype)


# ---------------------------------------------------------------------------
# collapse — the sample-selected collapse GEMM (linear only)
# ---------------------------------------------------------------------------

@register_site_op("collapse", "linear", "torch")
def collapse_torch(env, gamma, samples, *, compute_dtype):
    return CS.collapse_select_plain(env, gamma, samples, compute_dtype)


@register_site_op("collapse", "linear", "cuda")
def collapse_cuda(env, gamma, samples, *, compute_dtype):
    _on_card(env, "collapse")
    return CS.collapse_select(env, gamma, samples, compute_dtype)
