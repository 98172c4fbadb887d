"""BYO-MPS ingest: external site tensors → a sampling-ready GammaStore
(``repro.workloads.ingest``).

The samplers take their own MPS form: uniform-χ stacked ``gammas (M, χ, χ,
d)`` with the boundary row-0 convention and, for ``born`` semantics,
tensors whose left-to-right conditionals are normalised up to the
per-site rescale.  External MPS (DMRG output, a GBS covariance-matrix
decomposition, another tensor library's export) arrive as ragged chains
``[(D₀, D₁, d), (D₁, D₂, d), …]`` with boundary dimensions 1 and no
canonical form.

* :func:`load_tensors` — a list of arrays or an ``.npz`` archive (sites in
  key-sorted order), checked for three axes per site, one physical
  dimension, matching bonds and boundary dimensions 1.
* :func:`canonicalize_born` — a right-to-left QR sweep bringing a complex
  chain into right-canonical form, absorbing the R factors leftward and
  returning the state norm from site 0.  The sampled distribution is
  gauge-invariant; the sweep makes the per-site conditionals of Alg. 1
  well-conditioned.
* :func:`isometry_errors` — the acceptance gate, per-site ``max |B B† −
  I|`` on the ragged tensors (before any χ padding, so zero rows cannot
  hide a violation).  ``canonicalize=False`` turns ingest into
  validation: a chain outside tolerance raises :class:`IngestError`.
* :func:`build_mps` / :func:`ingest_mps` — the ragged chain embedded into
  the uniform-χ form (each site at ``[:Dl, :Dr, :]``; exact, because
  padded rows and columns are never reached from the boundary row) as a
  port :class:`~repro_torch.core.mps.MPS` on ``device``, and written
  through :meth:`GammaStore.write_mps` and
  :meth:`GammaStore.write_digest_manifest`, so the ingested store is
  verifiable and addressed by its digest from the first read.

``linear`` semantics (non-negative weights) has no gauge freedom —
re-normalising rows would change the distribution — so ingest checks
non-negativity and passes the weights through unchanged.

The checks and the QR sweep are numpy, as in the JAX package, so both
packages ingest the same tensors to the same chain and the same store
digest.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike

__all__ = ["IngestError", "IngestReport", "build_mps", "canonicalize_born",
           "ingest_mps", "isometry_errors", "load_tensors"]


class IngestError(ValueError):
    """The external MPS failed structural or semantic validation."""


@dataclasses.dataclass(frozen=True)
class IngestReport:
    """What ingest did and how good the input was."""

    n_sites: int
    chi: int                       # uniform embedding dimension (max bond)
    d: int
    semantics: str
    canonicalized: bool
    norm: float                    # state norm absorbed at site 0 (born)
    max_isometry_error: float      # post-canonicalization residual (born)
    input_bytes: int               # raw tensor bytes ingested
    digest: Optional[str] = None   # store Merkle root (None: no store)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


# -- loading & structural validation -----------------------------------------

def load_tensors(source) -> list[np.ndarray]:
    """External MPS → a validated ragged list of ``(Dl, Dr, d)`` arrays.

    ``source`` is a sequence of arrays or a path to an ``.npz`` archive
    whose arrays, in key-sorted order, are the site tensors (the order
    ``np.savez(path, *tensors)`` produces).  Raises :class:`IngestError`
    on any structural violation — wrong rank, mismatched physical or bond
    dimensions, non-trivial boundary bonds.
    """
    if isinstance(source, (str, os.PathLike)):
        with np.load(source) as z:
            keys = sorted(z.files)
            tensors = [np.asarray(z[k]) for k in keys]
    else:
        tensors = [np.asarray(t) for t in source]
    if not tensors:
        raise IngestError("empty MPS: no site tensors")
    for i, t in enumerate(tensors):
        if t.ndim != 3:
            raise IngestError(
                f"site {i}: expected a (Dl, Dr, d) tensor, got shape "
                f"{t.shape}")
    d = tensors[0].shape[2]
    for i, t in enumerate(tensors):
        if t.shape[2] != d:
            raise IngestError(
                f"site {i}: physical dimension {t.shape[2]} != {d} of "
                f"site 0 (the chain must share one physical dimension)")
    for i in range(len(tensors) - 1):
        if tensors[i].shape[1] != tensors[i + 1].shape[0]:
            raise IngestError(
                f"bond mismatch: site {i} right dim {tensors[i].shape[1]} "
                f"!= site {i + 1} left dim {tensors[i + 1].shape[0]}")
    if tensors[0].shape[0] != 1:
        raise IngestError(
            f"left boundary bond must be 1, got {tensors[0].shape[0]}")
    if tensors[-1].shape[1] != 1:
        raise IngestError(
            f"right boundary bond must be 1, got {tensors[-1].shape[1]}")
    return tensors


# -- canonical form -----------------------------------------------------------

def isometry_errors(tensors: Sequence[np.ndarray]) -> np.ndarray:
    """Per-site right-isometry residual ``max |B B† − I|`` with
    ``B = A.reshape(Dl, Dr·d)``, computed on the RAGGED tensors.

    Site 0 (Dl = 1) degenerates to ``| ‖A₀‖² − 1 |`` — the state-norm
    check.  Padding to uniform χ first would hide violations behind
    zero rows, which is why callers gate before embedding.
    """
    errs = np.empty(len(tensors))
    for i, t in enumerate(tensors):
        b = t.reshape(t.shape[0], -1)
        gram = b @ b.conj().T
        errs[i] = float(np.max(np.abs(gram - np.eye(t.shape[0]))))
    return errs


def canonicalize_born(tensors: Sequence[np.ndarray]
                      ) -> tuple[list[np.ndarray], float]:
    """Right-to-left QR sweep → (right-canonical ragged chain, norm).

    At each site i (last to first) the tensor's ``(Dr·d, Dl)``
    conjugate-transpose is QR-factored; Q† becomes the new site tensor
    (orthonormal rows by construction, possibly with a *smaller* left
    bond ``k = min(Dl, Dr·d)`` — rank truncation is exact here, no state
    change) and ``R†`` is absorbed into site i−1's right bond.  Site 0
    ends up carrying the whole state norm, which is divided out and
    returned.
    """
    out = [np.array(t, copy=True) for t in tensors]
    for i in range(len(out) - 1, 0, -1):
        a = out[i]
        dl, dr, d = a.shape
        b = a.reshape(dl, dr * d)
        q, r = np.linalg.qr(b.conj().T, mode="reduced")   # (Dr·d, k), (k, Dl)
        k = q.shape[1]
        out[i] = q.conj().T.reshape(k, dr, d)
        c = r.conj().T                                    # (Dl, k)
        out[i - 1] = np.einsum("lrs,rk->lks", out[i - 1], c)
    norm = float(np.linalg.norm(out[0]))
    if norm == 0.0:
        raise IngestError("zero-norm MPS: the state vanishes identically")
    out[0] = out[0] / norm
    return out, norm


# -- embedding ----------------------------------------------------------------

def _embed_uniform(tensors: Sequence[np.ndarray], dtype=None):
    """Ragged chain → uniform-χ stacked ``(M, χ, χ, d)`` Γ and ``(M, χ)``
    Λ = 1 (numpy).

    Exact: each site occupies the top-left ``[:Dl, :Dr]`` block and the
    samplers' boundary row-0 convention reaches only those blocks (the
    left env starts in row 0 = the Dl-1 boundary, and zero columns
    propagate zero weight)."""
    chi = max(max(t.shape[0], t.shape[1]) for t in tensors)
    d = tensors[0].shape[2]
    dtype = dtype or np.result_type(*[t.dtype for t in tensors])
    g = np.zeros((len(tensors), chi, chi, d), dtype=dtype)
    for i, t in enumerate(tensors):
        g[i, :t.shape[0], :t.shape[1], :] = t
    real = np.zeros(0, dtype=dtype).real.dtype
    lam = np.ones((len(tensors), chi), dtype=real)
    return g, lam


def build_mps(source, *, semantics: str = "born", canonicalize: bool = True,
              tol: float = 1e-6, lambdas=None, device: DeviceLike = None):
    """External tensors → (port :class:`~repro_torch.core.mps.MPS` on
    ``device``, the card unless ``"cpu"`` is asked for; report).

    born:   optionally canonicalize (right QR sweep), then gate on the
            per-site isometry residual — ``canonicalize=False`` rejects
            non-canonical input with :class:`IngestError` instead of
            fixing it.
    linear: validate non-negativity (no gauge freedom: re-normalizing
            rows would change the distribution); ``lambdas`` optionally
            supplies the per-site Λ vectors (default: ones).
    """
    from repro_torch.convert import mps_from_arrays
    tensors = load_tensors(source)
    input_bytes = sum(t.nbytes for t in tensors)
    norm = 1.0
    max_err = 0.0
    if semantics == "born":
        if lambdas is not None:
            raise IngestError("born ingest derives Λ = 1; the Schmidt "
                              "weights are absorbed into Γ by the QR sweep")
        if canonicalize:
            tensors, norm = canonicalize_born(tensors)
        errs = isometry_errors(tensors)
        max_err = float(errs.max())
        if max_err > tol:
            bad = int(errs.argmax())
            hint = ("QR sweep failed to converge — the input is "
                    "numerically degenerate" if canonicalize else
                    "pass canonicalize=True to re-gauge it")
            raise IngestError(
                f"site {bad} violates right-canonical form (isometry "
                f"residual {max_err:.3e} > tol {tol:.1e}); {hint}")
        g, lam = _embed_uniform(tensors)
    elif semantics == "linear":
        worst = min(float(np.min(t.real)) for t in tensors)
        if worst < -tol:
            raise IngestError(
                f"linear-semantics MPS must be non-negative; found entry "
                f"{worst:.3e} (a Born machine should ingest with "
                f"semantics='born')")
        if any(np.iscomplexobj(t) and np.abs(t.imag).max() > tol
               for t in tensors):
            raise IngestError("linear-semantics MPS must be real")
        tensors = [np.clip(t.real, 0.0, None) for t in tensors]
        g, lam = _embed_uniform(tensors)
        if lambdas is not None:
            if len(lambdas) != len(tensors):
                raise IngestError(
                    f"{len(lambdas)} Λ vectors for {len(tensors)} sites")
            for i, l in enumerate(lambdas):
                l = np.asarray(l, dtype=lam.dtype)
                if l.ndim != 1 or l.shape[0] != tensors[i].shape[1]:
                    raise IngestError(
                        f"Λ[{i}] must be a ({tensors[i].shape[1]},) vector "
                        f"matching site {i}'s right bond, got {l.shape}")
                if float(l.min()) < -tol:
                    raise IngestError(f"Λ[{i}] has negative entries")
                lam[i, :l.shape[0]] = np.clip(l, 0.0, None)
    else:
        raise IngestError(f"unknown semantics {semantics!r}")
    mps = mps_from_arrays(g, lam, semantics, device=device)
    report = IngestReport(
        n_sites=mps.n_sites, chi=mps.chi, d=mps.phys_dim,
        semantics=semantics,
        canonicalized=bool(semantics == "born" and canonicalize),
        norm=norm, max_isometry_error=max_err, input_bytes=input_bytes)
    return mps, report


def ingest_mps(source, root: str, *, semantics: str = "born",
               canonicalize: bool = True, tol: float = 1e-6, lambdas=None,
               storage_dtype: Optional[torch.dtype] = None,
               compute_dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None):
    """The end-to-end ingest: validate → canonicalise → embed → persist.

    Returns ``(GammaStore, IngestReport)``: the store is open (the caller
    closes it) and has a digest manifest, so every later read is
    verifiable and ``report.digest`` names it.

    Storage defaults: bf16 for real chains, complex64 for complex ones
    (both halve the disk bytes, §3.3.2); pass full-width dtypes for a
    lossless round trip.  ``device`` is where the chain is built before it
    is written (the card unless ``"cpu"`` is asked for).
    """
    from repro_torch.data.gamma_store import GammaStore
    mps, report = build_mps(source, semantics=semantics,
                            canonicalize=canonicalize, tol=tol,
                            lambdas=lambdas, device=device)
    is_complex = mps.gammas.is_complex()
    if storage_dtype is None:
        storage_dtype = torch.complex64 if is_complex else torch.bfloat16
    if compute_dtype is None:
        compute_dtype = torch.complex128 if is_complex else torch.float64
    store = GammaStore(root, storage_dtype=storage_dtype,
                       compute_dtype=compute_dtype)
    store.write_mps(mps)
    store.write_digest_manifest()
    report = dataclasses.replace(report, digest=store.digest())
    return store, report
