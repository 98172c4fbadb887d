"""Clamp specs: the conditional-sampling contract.

A *clamp* fixes the outcome of a subset of sites while the sampler walks
the rest of the chain as usual: a forced draw into the existing collapse
path, not a rejection filter.  The spec is carried on the session-level
:class:`repro_torch.api.SamplerConfig` through plan, engine and kernel
dispatch, so it must be hashable (session plans and the streamed engines'
keys contain the config) and JSON-round-trippable.

A copy of ``repro.workloads.clamp`` (numpy only): the canonical form is the
same, so a clamp spec hashes and serialises identically in both packages::

    ((site, outcome), ...)            # sorted by site
    ((site, (o_0, ..., o_{N-1})), ...)  # per-sample outcomes

Accepted inputs: ``None`` / ``{}`` (no clamp: normalises to ``None``, so an
empty clamp runs the unchanged unclamped code path), a ``{site: outcome}``
mapping (JSON object keys arrive as strings and are coerced), a ``{site:
[per-sample outcomes]}`` mapping, or an already-canonical pair sequence.
Malformed specs raise :class:`ValueError`.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

ClampSpec = Optional[tuple]


def _as_site(k) -> int:
    try:
        site = int(k)
    except (TypeError, ValueError):
        raise ValueError(f"clamp site {k!r} is not an integer") from None
    if isinstance(k, float) and k != site:
        raise ValueError(f"clamp site {k!r} is not an integer")
    if site < 0:
        raise ValueError(f"clamp site {site} is negative")
    return site


def _as_outcome(site: int, v) -> Union[int, tuple]:
    if isinstance(v, (str, bytes, dict)):
        raise ValueError(f"clamp outcome for site {site} must be an integer "
                         f"or a per-sample integer sequence, got {v!r}")
    if np.isscalar(v) or (isinstance(v, np.ndarray) and v.ndim == 0):
        try:
            o = int(v)
        except (TypeError, ValueError):
            raise ValueError(f"clamp outcome {v!r} for site {site} is not "
                             f"an integer") from None
        if o < 0:
            raise ValueError(f"clamp outcome {o} for site {site} is negative")
        return o
    try:
        seq = [int(x) for x in np.asarray(v).ravel().tolist()]
    except (TypeError, ValueError):
        raise ValueError(f"clamp outcome {v!r} for site {site} is not an "
                         f"integer or integer sequence") from None
    if not seq:
        raise ValueError(f"clamp for site {site} is an empty sequence")
    if any(o < 0 for o in seq):
        raise ValueError(f"clamp for site {site} contains negative outcomes")
    return tuple(seq)


def normalize_clamp(clamp) -> ClampSpec:
    """Any accepted input → the canonical hashable spec (or ``None``).

    Raises ``ValueError`` on malformed specs."""
    if clamp is None:
        return None
    if isinstance(clamp, dict):
        items = clamp.items()
    elif isinstance(clamp, (tuple, list)):
        items = []
        for pair in clamp:
            if (isinstance(pair, (str, bytes)) or
                    not hasattr(pair, "__len__") or len(pair) != 2):
                raise ValueError(f"clamp entry {pair!r} is not a "
                                 f"(site, outcome) pair")
            items.append((pair[0], pair[1]))
    else:
        raise ValueError(f"clamp must be a mapping or a (site, outcome) "
                         f"pair sequence, got {type(clamp).__name__}")
    out = {}
    for k, v in items:
        site = _as_site(k)
        if site in out:
            raise ValueError(f"clamp names site {site} twice")
        out[site] = _as_outcome(site, v)
    if not out:
        return None                     # empty ≡ unclamped, literally
    return tuple(sorted(out.items()))


def validate_clamp(clamp: ClampSpec, *, n_sites: int, d: int,
                   n_samples: Optional[int] = None) -> None:
    """Range-check a normalized spec against a concrete chain/batch.

    Plan-time validation: site ∈ [0, n_sites), outcome ∈ [0, d), and a
    per-sample sequence must cover exactly ``n_samples`` samples."""
    if clamp is None:
        return
    for site, outcome in clamp:
        if site >= n_sites:
            raise ValueError(f"clamp site {site} is outside the chain "
                             f"(n_sites={n_sites})")
        vals = outcome if isinstance(outcome, tuple) else (outcome,)
        for o in vals:
            if o >= d:
                raise ValueError(f"clamp outcome {o} at site {site} is "
                                 f"outside the physical dimension (d={d})")
        if isinstance(outcome, tuple) and n_samples is not None \
                and len(outcome) != n_samples:
            raise ValueError(f"per-sample clamp at site {site} covers "
                             f"{len(outcome)} samples, batch has "
                             f"{n_samples}")


def clamp_map(clamp: ClampSpec) -> Optional[dict]:
    """Canonical spec → ``{site: int | (N,) int32 array}`` for array
    construction (``None`` for no clamp)."""
    if clamp is None:
        return None
    return {site: (np.asarray(outcome, dtype=np.int32)
                   if isinstance(outcome, tuple) else int(outcome))
            for site, outcome in clamp}


def segment_clamp_arrays(cmap: dict, start: int, length: int,
                         n_samples: int) -> tuple[np.ndarray, np.ndarray]:
    """The per-segment arrays of the clamp for sites [start, start+length).

    Returns ``(mask (L,) bool, vals (L, N) int32)``.  Sites past the
    chain end are absent from ``cmap`` and stay unmasked (the port's
    streaming engine walks no identity pad sites, so it never asks)."""
    mask = np.zeros((length,), dtype=bool)
    vals = np.zeros((length, n_samples), dtype=np.int32)
    for site, outcome in cmap.items():
        if start <= site < start + length:
            mask[site - start] = True
            vals[site - start, :] = outcome   # scalar broadcasts; (N,) copies
    return mask, vals


def parse_clamp_arg(text: str) -> Optional[dict]:
    """CLI syntax ``"site=outcome,site=outcome,..."`` → a clamp mapping.

    Used by ``repro_torch.launch.sample --clamp``; raises ``ValueError``
    with the offending token on malformed input."""
    if not text:
        return None
    out = {}
    for tok in text.split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(f"clamp token {tok!r} is not site=outcome")
        s, o = tok.split("=", 1)
        try:
            out[int(s)] = int(o)
        except ValueError:
            raise ValueError(f"clamp token {tok!r} is not "
                             f"integer=integer") from None
    return out or None


__all__ = ["ClampSpec", "clamp_map", "normalize_clamp", "parse_clamp_arg",
           "segment_clamp_arrays", "validate_clamp"]
