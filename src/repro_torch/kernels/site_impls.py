"""Registered implementations behind ``kernels/dispatch.py``.

Stage signature (semantics is part of the registry key):

* ``site_step(env, gamma, lam, u, *, scaling, compute_dtype)``
  → ``(env', samples, dlog)`` with u (N, 1)

The ``torch`` cells are the plain versions in ``kernels/site_step.py``; the
``cuda`` cells launch the Hopper kernels and rescale ``global`` outside, as
the JAX package's Pallas cells do (the global max crosses row tiles).
"""
from __future__ import annotations

import torch

from repro_torch.core import precision
from repro_torch.core.precision import real_dtype_of
from repro_torch.kernels.dispatch import register_site_op
from repro_torch.kernels.site_step import (  # noqa: F401  (draw re-exported)
    draw_from_uniform, site_step_born, site_step_born_plain,
    site_step_linear, site_step_linear_plain)


def _no_compute_dtype(compute_dtype) -> None:
    if compute_dtype is not None:
        raise NotImplementedError(
            "compute_dtype (bf16 GEMM inputs) is not ported yet "
            "(ROADMAP.md §1 row 7)")


def site_probs_dtype(env, gamma, lam, semantics: str,
                     compute_dtype) -> torch.dtype:
    """The dtype the measurement probabilities (and hence the inverse-CDF
    uniforms) come out as: the promoted operand dtype, made real for Born.
    Callers pre-draw ``u`` with exactly this dtype so every backend consumes
    the same bits."""
    _no_compute_dtype(compute_dtype)
    dt = torch.promote_types(torch.promote_types(env.dtype, gamma.dtype),
                             lam.dtype)
    return real_dtype_of(dt) if semantics == "born" else dt


@register_site_op("site_step", "linear", "torch")
def site_step_linear_torch(env, gamma, lam, u, *, scaling, compute_dtype):
    _no_compute_dtype(compute_dtype)
    return site_step_linear_plain(env, gamma, lam, u[:, 0], scaling=scaling)


@register_site_op("site_step", "born", "torch")
def site_step_born_torch(env, gamma, lam, u, *, scaling, compute_dtype):
    _no_compute_dtype(compute_dtype)
    return site_step_born_plain(env, gamma, lam, u[:, 0], scaling=scaling)


def _site_step_cuda(kernel, env, gamma, lam, u, scaling, compute_dtype):
    _no_compute_dtype(compute_dtype)
    if env.device.type != "cuda":
        raise ValueError("the cuda site-step cell needs tensors on a CUDA "
                         f"device; got {env.device}")
    fused = scaling if scaling in ("per_sample", "none") else "none"
    env2, samples, dlog = kernel(env, gamma, lam, u[:, 0], scaling=fused)
    if scaling == "global":
        env2, dlog = precision.rescale(env2, "global")
    return env2, samples, dlog


@register_site_op("site_step", "linear", "cuda")
def site_step_linear_cuda(env, gamma, lam, u, *, scaling, compute_dtype):
    return _site_step_cuda(site_step_linear, env, gamma, lam, u, scaling,
                           compute_dtype)


@register_site_op("site_step", "born", "cuda")
def site_step_born_cuda(env, gamma, lam, u, *, scaling, compute_dtype):
    return _site_step_cuda(site_step_born, env, gamma, lam, u, scaling,
                           compute_dtype)
