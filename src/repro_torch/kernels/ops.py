"""Public entry point for the fused site step, routed through the dispatch
registry (``kernels="auto"``: the CUDA kernel on the card, the plain
PyTorch cell on the CPU)."""
from __future__ import annotations

from repro_torch.kernels.dispatch import get_site_op, resolve_kernels


def site_step(env, gamma, lam, u, kernels: str = "auto",
              semantics: str = "linear", scaling: str = "per_sample"):
    """One whole site (see ``kernels/site_step.py``): contract → measure →
    inverse-CDF draw with the given uniforms u (N, 1) → collapse →
    rescale.  Returns (env', samples, dlog)."""
    op = get_site_op("site_step", semantics, resolve_kernels(kernels,
                                                             env.device))
    return op(env, gamma, lam, u, scaling=scaling, compute_dtype=None)


__all__ = ["site_step", "resolve_kernels"]
