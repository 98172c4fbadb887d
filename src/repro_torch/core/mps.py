"""Matrix Product State container, random builders and exact oracles.

Mirrors ``repro.core.mps``.  Two semantics (see that module's docstring):

- ``linear``: non-negative weights, ``probs = temp · Λ`` (an HMM);
- ``born``: complex amplitudes in Vidal form, ``p(s) = Σ_r |temp λ|²``.

``gammas (M, χ, χ, d)`` holds the site tensors (``gammas[i][l, r, s]`` maps
left bond ``l`` to right bond ``r`` on outcome ``s``) and ``lambdas (M, χ)``
the per-site Λ / Schmidt weights.

The builders take a key of the port's threefry (``core/prng.py``) and draw
what the JAX builders draw from the same key, so a seed names the same
chain in both packages (the Born builder to rounding: see its docstring).
Each builder allocates the whole chain once on ``device`` (the card unless
``device="cpu"``) and fills it a site at a time, so the peak memory stays
near the chain's own size.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import DeviceLike, resolve_device


TP_SCHEMES = ("tp_single", "tp_double")


def site_tile(gamma, scheme: str, p2: int, rank: int, site: int):
    """Rank ``rank``'s tile of one site's Γ (χ, χ, d) under a tensor-parallel
    scheme over p₂ ranks (the JAX package's ``shard_map`` ``in_specs``):
    ``tp_single`` rows [r·χ/p₂, (r+1)·χ/p₂) of every site; ``tp_double`` the
    same rows of the sites it contracts split-K (``site`` even) and those
    columns, the right bond, of the others.  Slicing only: a numpy array or a
    tensor gives a view of itself."""
    if scheme not in TP_SCHEMES:
        raise ValueError(f"{scheme!r} has no tiles (one of {TP_SCHEMES})")
    w = gamma.shape[0] // p2
    if scheme == "tp_double" and site % 2:
        return gamma[:, rank * w:(rank + 1) * w]
    return gamma[rank * w:(rank + 1) * w]


@dataclasses.dataclass
class MPS:
    """Uniform-χ stacked MPS (see module docstring)."""

    gammas: torch.Tensor
    lambdas: torch.Tensor
    semantics: str = "linear"

    @property
    def n_sites(self) -> int:
        return self.gammas.shape[0]

    @property
    def chi(self) -> int:
        return self.gammas.shape[1]

    @property
    def phys_dim(self) -> int:
        return self.gammas.shape[3]

    @property
    def device(self) -> torch.device:
        return self.gammas.device

    def to(self, device=None, dtype=None) -> "MPS":
        """Move and/or cast.  Born Λ stays real when Γ is complex; a Γ cast
        to a half type (the ``store_bf16`` tier) keeps Λ in fp32, since only
        Γ's storage is halved."""
        lam_dtype = dtype
        if dtype is not None and dtype.is_complex:
            lam_dtype = torch.empty((), dtype=dtype).real.dtype
        elif dtype in (torch.bfloat16, torch.float16):
            lam_dtype = torch.float32
        return MPS(self.gammas.to(device=device, dtype=dtype),
                   self.lambdas.to(device=device, dtype=lam_dtype),
                   self.semantics)


# ---------------------------------------------------------------------------
# Random MPS generation (site by site into one preallocated chain)
# ---------------------------------------------------------------------------

# counters per uniform call while a site is filled: bounds the threefry
# temporaries (a few int64 words per counter) to about a GB
_DRAW_CHUNK = 2 ** 25


def random_linear_mps(key, n_sites: int, chi: int, d: int,
                      decay: float = 0.0, dtype: torch.dtype = torch.float64,
                      device: DeviceLike = None) -> MPS:
    """Random non-negative ("linear") MPS, as ``repro.core.mps``'s builder
    draws it from the same key: ``kg, kl, kd = split(key, 3)``; Γ from
    ``uniform(kg, (M, χ, χ, d))`` with each row normalised so that
    Σ_(r,s) Γ = 1; ``decay`` shrinks site i by ``10**(-decay·(1+U_i))``
    with ``U = uniform(kd, (M, 1, 1, 1))``; Λ = 1 + ``uniform(kl, (M, χ))``.
    Γ is drawn in pieces whose counters are the whole-array draw's, so the
    bits are the same."""
    dev = resolve_device(device)
    kg, kl, kd = prng.split(key, 3)
    gammas = torch.empty((n_sites, chi, chi, d), dtype=dtype, device=dev)
    scale = (prng.uniform(kd, (n_sites,), dtype=dtype, device=dev)
             if decay else None)
    for i in range(n_sites):
        _linear_site(kg, i, gammas[i])
        if decay:
            gammas[i] *= 10.0 ** (-decay * (1.0 + scale[i]))
    lambdas = 1.0 + prng.uniform(kl, (n_sites, chi), dtype=dtype, device=dev)
    return MPS(gammas, lambdas, "linear")


def _linear_site(kg, i: int, g: torch.Tensor) -> None:
    """Fill ``g`` (χ, χ, d) with site i of ``uniform(kg, (M, χ, χ, d))``, each
    row normalised so that Σ_(r,s) Γ = 1; drawn in pieces whose counters
    are the whole-array draw's."""
    chi, _, d = g.shape
    rows = max(1, _DRAW_CHUNK // (chi * d))
    for r0 in range(0, chi, rows):
        r1 = min(chi, r0 + rows)
        g[r0:r1] = prng.uniform(kg, (r1 - r0, chi, d), dtype=g.dtype,
                                device=g.device,
                                offset=(i * chi + r0) * chi * d)
    g /= g.sum(dim=(1, 2), keepdim=True)


def random_born_mps(key, n_sites: int, chi: int, d: int,
                    dtype: torch.dtype = torch.complex128,
                    device: DeviceLike = None) -> MPS:
    """Random complex MPS in right-canonical form, as ``repro.core.mps``'s
    builder draws it from the same key: site i splits ``split(key, M)[i]``
    into (kr, ki), draws a (χ, χ·d) matrix with real part ``normal(kr)``
    and imaginary part ``normal(ki)``, and keeps the conjugate transpose of
    the Q of its conjugate transpose's QR, so ``Σ_s Γ^s Γ^s† = I``; λ = 1.

    The uniforms are the JAX package's bit for bit; erfinv and LAPACK's QR
    round otherwise than XLA's, so the chain agrees to rounding only."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    dev = resolve_device(device)
    keys = prng.split(key, n_sites)
    size = chi * chi * d
    gammas = torch.empty((n_sites, chi, chi, d), dtype=dtype, device=dev)
    for i in range(n_sites):
        planes = []
        for k in prng.split(keys[i]):
            plane = torch.empty(size, dtype=real, device=dev)
            for o in range(0, size, _DRAW_CHUNK):
                c = min(_DRAW_CHUNK, size - o)
                plane[o:o + c] = prng.normal(k, (c,), dtype=real, device=dev,
                                             offset=o)
            planes.append(plane.reshape(chi, chi * d))
        a = torch.complex(*planes)
        del planes
        q, _ = torch.linalg.qr(a.conj().T, mode="reduced")   # (χ·d, χ)
        del a
        gammas[i].copy_(q.conj().T.reshape(chi, chi, d))
        del q
    lambdas = torch.ones((n_sites, chi), dtype=real, device=dev)
    return MPS(gammas, lambdas, "born")


def gbs_like_mps(key, n_sites: int, chi: int, d: int,
                 photon_decay: float = 0.002,
                 dtype: torch.dtype = torch.float64,
                 device: DeviceLike = None) -> MPS:
    """Synthetic GBS-flavoured linear MPS, as ``repro.core.mps`` draws it
    from the same key: a decaying random linear chain whose vacuum outcome
    (s = 0) is boosted towards the chain's edges."""
    mps = random_linear_mps(key, n_sites, chi, d, decay=photon_decay * 50,
                            dtype=dtype, device=device)
    for i in range(n_sites):
        _edge_boost(mps.gammas[i], i, n_sites)
    return mps


def _edge_boost(g: torch.Tensor, i: int, n_sites: int) -> None:
    """Boost site i's vacuum outcome towards the chain's edges."""
    centre = (n_sites - 1) / 2.0
    edge = abs(i - centre) / centre if centre else 0.0
    g[:, :, 0] *= 1.0 + 4.0 * edge
    g /= g.sum(dim=(1, 2), keepdim=True)


def gbs_like_site(key, i: int, n_sites: int, chi: int, d: int,
                  photon_decay: float = 0.002,
                  dtype: torch.dtype = torch.float64,
                  device: DeviceLike = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Site i of ``gbs_like_mps(key, n_sites, ...)`` alone: (Γ (χ, χ, d),
    Λ (χ,)), bit for bit, so a chain larger than the device is made a site
    at a time (e.g. straight into a ``GammaStore``)."""
    dev = resolve_device(device)
    kg, kl, kd = prng.split(key, 3)
    g = torch.empty((chi, chi, d), dtype=dtype, device=dev)
    _linear_site(kg, i, g)
    decay = photon_decay * 50
    if decay:
        scale = prng.uniform(kd, (1,), dtype=dtype, device=dev, offset=i)
        g *= 10.0 ** (-decay * (1.0 + scale[0]))
    _edge_boost(g, i, n_sites)
    lam = 1.0 + prng.uniform(kl, (chi,), dtype=dtype, device=dev,
                             offset=i * chi)
    return g, lam


# ---------------------------------------------------------------------------
# Exact oracles (numpy; exponential in M, keep M small)
# ---------------------------------------------------------------------------

def enumerate_probabilities(mps: MPS) -> np.ndarray:
    """Exact joint distribution over all d**M outcomes, as the product of
    the per-site conditionals the sampler draws from (float64)."""
    g = mps.gammas.detach().cpu().numpy()
    lam = mps.lambdas.detach().cpu().numpy()
    M, chi, _, d = g.shape
    outcomes = np.stack(np.meshgrid(*([np.arange(d)] * M), indexing="ij"),
                        axis=-1).reshape(-1, M)

    linear = mps.semantics == "linear"
    probs = np.zeros(len(outcomes))
    for idx, s in enumerate(outcomes):
        env = np.zeros(chi, dtype=complex)
        env[0] = 1.0
        logp = 0.0
        for i in range(M):
            temp = np.einsum("l,lrs->rs", env, g[i])  # (chi, d)
            if linear:
                cond = np.real(temp.T @ lam[i])  # (d,)
            else:
                cond = np.sum(np.abs(temp.T * lam[i][None, :]) ** 2, axis=1)
            total = cond.sum()
            logp += np.log(cond[s[i]] / total)
            env = temp[:, s[i]]
            if not linear:
                env = env * lam[i]
            nrm = np.abs(env).sum()
            if nrm > 0:
                env = env / nrm
        probs[idx] = np.exp(logp)
    return probs / probs.sum()


def exact_site_marginals(mps: MPS) -> np.ndarray:
    """Per-site marginal distribution, (M, d), via the joint (small M)."""
    M, d = mps.n_sites, mps.phys_dim
    joint = enumerate_probabilities(mps)
    outcomes = np.stack(np.meshgrid(*([np.arange(d)] * M), indexing="ij"),
                        axis=-1).reshape(-1, M)
    marg = np.zeros((M, d))
    for i in range(M):
        for s in range(d):
            marg[i, s] = joint[outcomes[:, i] == s].sum()
    return marg
