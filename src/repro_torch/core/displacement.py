"""Displacement operator via the Zassenhaus split (paper §3.4.1).

The GBS random displacement applies ``D(μ) = exp(μ a† − μ* a)`` with a fresh
complex μ per sample, on the d-dimensional truncated Fock space.  The paper
splits it into closed-form triangular factors:

    exp(μ a† − μ* a) ≈ e^{−|μ|²/2} · exp(μ a†) · exp(−μ* a)        (Eq. 6)

    exp(μ a†)[j, k]  = μ^{j−k} √(j!/k!) / (j−k)!      (lower, j ≥ k)
    exp(−μ* a)[j, k] = (−μ*)^{k−j} √(k!/j!) / (k−j)!  (upper, k ≥ j)

(exact in infinite dimension; on the truncated space the error lives in the
last rows and columns).  Batched over μ (B,).  The fused kernel is
``kernels/displacement_expm.py``, reached through
``kernels/ops.displacement_matrices``; :func:`displace_env` keeps the
reference's route through the plain :func:`displacement_zassenhaus`.

The powers μ^m are repeated products (:func:`powers`) rather than a
complex ``pow``, so μ = 0 gives 1, 0, 0, … exactly.
"""
from __future__ import annotations

import torch


def powers(z: torch.Tensor, d: int) -> torch.Tensor:
    """(B,) complex → (B, d): z⁰ … z^{d−1} as repeated products."""
    steps = torch.cat([torch.ones_like(z)[:, None],
                       z[:, None].expand(-1, d - 1)], dim=1)
    return torch.cumprod(steps, dim=1)


def ladder_ops(d: int, dtype=torch.complex128, device=None):
    """Annihilation and creation operators on the d-dim truncated Fock space:
    ``a |k> = √k |k−1>``; returns (a, a†)."""
    sq = torch.sqrt(torch.arange(1, d, dtype=torch.float64, device=device))
    a = torch.diag(sq, 1).to(dtype)
    return a, a.conj().T.resolve_conj()


def _tri_factor_log_coeffs(d: int, dtype, device=None):
    """(m, coeff): the μ-power m = j − k and the √(j!/k!)/(j−k)! table
    (0 where m < 0), computed from ``torch.lgamma`` in ``dtype`` (real)."""
    j = torch.arange(d, dtype=dtype, device=device)[:, None]
    k = torch.arange(d, dtype=dtype, device=device)[None, :]
    m = j - k
    logc = (0.5 * (torch.lgamma(j + 1) - torch.lgamma(k + 1))
            - torch.lgamma(m.clamp(min=0) + 1))
    return m, torch.where(m >= 0, torch.exp(logc), torch.zeros_like(logc))


def exp_mu_adag(mu: torch.Tensor, d: int) -> torch.Tensor:
    """Batched exp(μ a†): (B,) complex μ → (B, d, d) lower-triangular."""
    m, coeff = _tri_factor_log_coeffs(d, mu.real.dtype, mu.device)
    idx = m.clamp(min=0).to(torch.int64)
    return powers(mu, d)[:, idx] * coeff.to(mu.dtype)


def exp_neg_mustar_a(mu: torch.Tensor, d: int) -> torch.Tensor:
    """Batched exp(−μ* a): (B,) → (B, d, d) upper-triangular."""
    return exp_mu_adag(-mu.conj(), d).transpose(-1, -2)


def displacement_zassenhaus(mu: torch.Tensor, d: int,
                            correction: bool = False) -> torch.Tensor:
    """D(μ) ≈ e^{−|μ|²/2} exp(μ a†) exp(−μ* a), batched (B,) → (B, d, d).

    ``correction=True`` is, as in the reference, a placeholder: it multiplies
    the columns by a vector of ones (the reference sets the top level to
    exp(0) = 1, a hook for the paper's diagonal commutator term), so the
    result equals ``correction=False``.
    """
    pref = torch.exp(-0.5 * mu.abs() ** 2).to(mu.dtype)[:, None, None]
    out = pref * torch.matmul(exp_mu_adag(mu, d), exp_neg_mustar_a(mu, d))
    if correction:
        corr = torch.ones((d,), dtype=mu.dtype, device=mu.device)
        out = out * corr[None, None, :]
    return out


def displacement_exact(mu: torch.Tensor, d: int) -> torch.Tensor:
    """Reference: ``matrix_exp`` of μa† − μ*a over the batch."""
    a, adag = ladder_ops(d, dtype=mu.dtype, device=mu.device)
    gen = mu[:, None, None] * adag[None] - mu.conj()[:, None, None] * a[None]
    return torch.linalg.matrix_exp(gen)


def displace_env(env: torch.Tensor, mu: torch.Tensor, d: int,
                 method: str = "zassenhaus") -> torch.Tensor:
    """Apply the per-sample displacement to the physical leg: env (N, χ, d),
    mu (N,) → out[n, r, :] = D(μ_n) @ env[n, r, :]."""
    if method == "zassenhaus":
        dmats = displacement_zassenhaus(mu, d)
    elif method == "exact":
        dmats = displacement_exact(mu, d)
    else:
        raise ValueError(method)
    return torch.einsum("nst,nrt->nrs", dmats, env.to(dmats.dtype))
