"""Public entry points for the kernels, routed through the dispatch registry
(``kernels="auto"``: the CUDA kernel on the card, the plain PyTorch cell on
the CPU), and the launch counts of every kernel wrapper."""
from __future__ import annotations

import torch

from repro_torch.kernels import collapse_select as CS
from repro_torch.kernels import contract_measure as CM
from repro_torch.kernels import displacement_expm as DE
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import site_step as SS
from repro_torch.kernels.dispatch import get_site_op, resolve_kernels

_COUNTED = (SS, CM, CS, DE, FA)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, by wrapper name."""
    return {name: n for mod in _COUNTED for name, n in mod.LAUNCHES.items()}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for mod in _COUNTED:
        mod.reset_launches()


def contract_measure(env, gamma, lam, kernels: str = "auto"):
    """Site contraction + linear measurement. Returns (temp, probs)."""
    op = get_site_op("contract_measure", "linear",
                     resolve_kernels(kernels, env.device))
    return op(env, gamma, lam, semantics="linear", compute_dtype=None)


def displacement_matrices(mu, d: int, kernels: str = "auto"):
    """Batched D(μ) (B, d, d) complex from complex μ (B,): the CUDA kernel
    on the card (its complex entry, which reads μ and writes D(μ) as they
    lie), its plain version for ``kernels="torch"`` or on the CPU."""
    mu = mu.resolve_conj().contiguous()
    if resolve_kernels(kernels, mu.device) == "cuda":
        return DE.displacement_expm_complex(mu, d)
    return DE.displacement_expm_complex_plain(mu, d)


def flash_attention(q, k, v, causal: bool = True, kernels: str = "auto"):
    """Full-sequence attention q (B, S, H, Dh), k/v (B, T, KVH, Dh) → out
    (B, S, H, Dh): the CUDA flash kernel on the card, its plain version for
    ``kernels="torch"`` or on the CPU."""
    if resolve_kernels(kernels, q.device) == "cuda":
        return FA.flash_attention(q, k, v, causal=causal)
    return FA.flash_attention_plain(q, k, v, causal=causal)


def collapse_rescale(env, gamma, samples, kernels: str = "auto"):
    """Sample-selected collapse + per-sample rescale (§3.3):
    env (N, L) · Γ[:, :, sₙ] → env' (N, R), rescaled to unit per-row max."""
    op = get_site_op("collapse", "linear", resolve_kernels(kernels,
                                                           env.device))
    env_new = op(env, gamma, samples, compute_dtype=None)
    m = env_new.abs().amax(dim=1, keepdim=True)
    return env_new / torch.where(m > 0, m, 1.0)


def site_step(env, gamma, lam, u, kernels: str = "auto",
              semantics: str = "linear", scaling: str = "per_sample"):
    """One whole site (see ``kernels/site_step.py``): contract → measure →
    inverse-CDF draw with the given uniforms u (N, 1) → collapse →
    rescale.  Returns (env', samples, dlog)."""
    op = get_site_op("site_step", semantics, resolve_kernels(kernels,
                                                             env.device))
    return op(env, gamma, lam, u, scaling=scaling, compute_dtype=None)


__all__ = ["collapse_rescale", "contract_measure", "displacement_matrices",
           "flash_attention", "launch_counts", "reset_launches",
           "resolve_kernels", "site_step"]
