"""Dynamic bond dimensions (paper §3.4.2, Table 1).

The area law makes entanglement, and with it the useful bond dimension,
grow from the chain's edges towards its centre.  A fixed χ wastes compute
at the edges, so each site gets its own χᵢ from the entanglement profile.

χᵢ is quantized to a few plateau values (*buckets*); consecutive sites of
one bucket form a *stage*, and the walk runs stage by stage with the
environment sliced or zero-padded at each stage boundary
(:func:`fit_env`).  The Table 1 accounting (equivalent χ, step ratio, comp
ratio) is computed from the un-bucketed profile.

Profiles are numpy arrays, as in the JAX package (``repro.core.
dynamic_bond``); environments are torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core import sampler as S
from repro_torch.core.mps import MPS


def area_law_profile(n_sites: int, chi_max: int, n_photon: float = 1.0,
                     d: int = 3) -> np.ndarray:
    """Entanglement-derived per-site χ: exponential growth from both edges
    (the bond at cut i carries at most (1 + n_photon)^dist states), a
    plateau of ``chi_max`` in the centre — the paper's Fig. 8."""
    i = np.arange(n_sites, dtype=np.float64)
    dist = np.minimum(i + 1, n_sites - 1 - i)          # distance to an edge
    log_bound = np.minimum(dist * np.log1p(n_photon), np.log(1e18))
    chi = np.minimum(np.exp(log_bound), chi_max)
    return np.maximum(chi.astype(np.int64), 1)


def bucketize(profile: np.ndarray, buckets: Sequence[int]) -> np.ndarray:
    """Round each site's χ up to the nearest allowed bucket."""
    buckets = np.sort(np.asarray(buckets))
    idx = np.searchsorted(buckets, profile, side="left")
    idx = np.minimum(idx, len(buckets) - 1)
    out = buckets[idx]
    if (out < profile).any():
        out = np.where(out < profile, buckets[-1], out)
    return out


@dataclasses.dataclass(frozen=True)
class Stage:
    start: int
    stop: int
    chi: int


def stages_from_profile(bucketed: np.ndarray) -> list[Stage]:
    """Maximal runs of one bucket, in chain order."""
    stages: list[Stage] = []
    start = 0
    for i in range(1, len(bucketed) + 1):
        if i == len(bucketed) or bucketed[i] != bucketed[start]:
            stages.append(Stage(start, i, int(bucketed[start])))
            start = i
    return stages


def fit_env(env: torch.Tensor, chi: int) -> torch.Tensor:
    """Adapt an (N, χ_prev) environment to a stage of bond dimension χ: a
    shrink slices, a growth zero-pads (truncated bond components carry
    about zero weight in an area-law state).  Every staged walk — the
    in-memory one, the streaming engine, the DP/TP stage loop of
    ``api/backends.py`` — goes through this one rule.  The result is
    contiguous, as the kernels take it."""
    if env.shape[1] > chi:
        return env[:, :chi].contiguous()
    if env.shape[1] < chi:
        return torch.nn.functional.pad(env, (0, chi - env.shape[1]))
    return env


def table1_metrics(profile: np.ndarray, chi_fixed: int) -> dict[str, float]:
    """The paper's Table 1 columns for a χ profile against a fixed-χ run."""
    prof = np.minimum(profile, chi_fixed).astype(np.float64)
    equiv_chi = float(np.sqrt(np.mean(prof ** 2)))
    step_ratio = float(np.mean(prof >= chi_fixed))
    comp_ratio = float(np.mean(prof ** 2) / chi_fixed ** 2)
    return {"equiv_chi": equiv_chi, "step_ratio": step_ratio,
            "comp_ratio": comp_ratio}


def stage_mps(mps: MPS, start: int, stop: int, chi: int) -> MPS:
    """Sites [start, stop) of ``mps`` with both bonds cut to χ, contiguous."""
    return MPS(mps.gammas[start:stop, :chi, :chi, :].contiguous(),
               mps.lambdas[start:stop, :chi].contiguous(), mps.semantics)


def truncate_mps_to_profile(mps: MPS, bucketed: np.ndarray) -> list[MPS]:
    """Slice a uniform-χ MPS into per-stage MPSs with the bucketed χ (the
    rank-truncation analogue of the paper's high-amplitude filter)."""
    return [stage_mps(mps, st.start, st.stop, st.chi)
            for st in stages_from_profile(bucketed)]


def walk_stages(stage_mpss: Sequence[MPS], n_samples: int,
                key: torch.Tensor,
                config: S.SamplerConfig = S.SamplerConfig()
                ) -> tuple[torch.Tensor, S.SamplerState]:
    """The staged walk over per-stage MPSs that cover the chain in order:
    ``fit_env`` at each boundary, then ``sample_chain`` from the stage's
    first site.  Returns ((N, M) outcomes, the final state)."""
    state = S.init_state(stage_mpss[0], n_samples, key, config)
    outs, offset = [], 0
    for sm in stage_mpss:
        state = S.SamplerState(fit_env(state.env, sm.chi), state.key,
                               state.log_scale)
        res = S.sample_chain(sm, state, config, start_site=offset)
        state = res.state
        offset += sm.n_sites
        outs.append(res.samples)
    return torch.cat(outs, dim=0).T, state


def sample_staged(mps: MPS, bucketed: np.ndarray, n_samples: int,
                  key: torch.Tensor,
                  config: S.SamplerConfig = S.SamplerConfig()
                  ) -> torch.Tensor:
    """The chain as a sequence of fixed-χ stages; returns (N, M)."""
    return walk_stages(truncate_mps_to_profile(mps, bucketed), n_samples,
                       key, config)[0]


def sample_staged_batched(mps: MPS, bucketed: np.ndarray, n_samples: int,
                          key: torch.Tensor, micro_batch: int,
                          config: S.SamplerConfig = S.SamplerConfig()
                          ) -> torch.Tensor:
    """§3.1 micro batching composed with the staged walk: chunk c walks the
    whole chain on ``split(key, n_micro)[c]``, the ``sample_batched`` key
    schedule the streaming engine's micro-batched segments use too."""
    if micro_batch < 1 or n_samples % micro_batch:
        raise ValueError(f"micro_batch={micro_batch} must divide "
                         f"n_samples={n_samples}")
    stage_mpss = truncate_mps_to_profile(mps, bucketed)
    keys = prng.split(key, n_samples // micro_batch)
    return torch.cat([walk_stages(stage_mpss, micro_batch, k, config)[0]
                      for k in keys], dim=0)
