"""Sequential MPS chain sampler (the paper's Figure 1 workflow + Alg. 1).

The walk goes left→right carrying a left environment ``env (N, χ)``.  At
each site i: contract with Γ_i, measure (linear ``temp·Λ`` or Born
``Σ_r |temp λ|²``), draw by inverse CDF with one uniform per sample,
collapse onto the drawn outcome, and rescale each sample (§3.3).

The site body is dispatched through ``kernels/dispatch.py``: the Hopper
kernel (``kernels="cuda"``) or the plain PyTorch cell (``"torch"``).  The
uniforms are drawn here, before the dispatch, from ``fold_in(key, site)``
with the port's bit-exact threefry, so both backends — and the JAX
package — consume the same bits (§4.1).

The JAX package's ``lax.scan`` over the stacked sites is a Python loop here;
``start_site`` stays in the ``fold_in`` index so a resumed walk draws what
the uninterrupted one would have.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core import prng
from repro_torch.core.mps import MPS
from repro_torch.core.precision import real_dtype_of
from repro_torch.kernels import dispatch
from repro_torch.kernels.site_impls import site_probs_dtype


class SamplerState(NamedTuple):
    """Carry of the chain walk — also the unit of mid-chain resume."""
    env: torch.Tensor        # (N, χ) left environment (rescaled)
    key: torch.Tensor        # base PRNG key; site i draws with fold_in(key, i)
    log_scale: torch.Tensor  # (N,) accumulated log10 of the rescale factors


class SampleResult(NamedTuple):
    samples: torch.Tensor     # (M, N) int64 outcomes (site-major)
    state: SamplerState
    site_stats: torch.Tensor  # (M, 3) [max |env|, min nonzero |env|, mean s]


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    semantics: str = "linear"          # "linear" | "born"
    scaling: str = "per_sample"        # "none" | "global" | "per_sample"
    # bf16 GEMM inputs with fp32 sums (linear; the mxu_bf16/store_bf16 tiers)
    compute_dtype: Optional[torch.dtype] = None
    kernels: str = "auto"              # "cuda" | "torch" | "auto"


def init_state(mps: MPS, n_samples: int, key: torch.Tensor,
               config: SamplerConfig = SamplerConfig()) -> SamplerState:
    """Boundary condition: env starts as the one-hot left boundary row."""
    dtype = mps.gammas.dtype
    if dtype in (torch.bfloat16, torch.float16):   # low-precision Γ storage
        dtype = torch.float32                      # never a low-precision env
    env = torch.zeros((n_samples, mps.chi), dtype=dtype, device=mps.device)
    env[:, 0] = 1.0
    log_scale = torch.zeros((n_samples,), dtype=real_dtype_of(dtype),
                            device=mps.device)
    return SamplerState(env, key, log_scale)


def site_step(state: SamplerState, site, config: SamplerConfig):
    """One site of the chain: contract → measure → collapse → rescale."""
    gamma, lam, site_idx = site            # (χ, χ, d), (χ,), int
    env, key, log_scale = state
    sub = prng.fold_in(key, site_idx)
    u = prng.uniform(sub, (env.shape[0], 1),
                     dtype=site_probs_dtype(env, gamma, lam, config.semantics,
                                            config.compute_dtype),
                     device=env.device)
    backend = dispatch.resolve_kernels(config.kernels, env.device)
    op = dispatch.get_site_op("site_step", config.semantics, backend)
    new_env, samples, dlog = op(env, gamma, lam, u, scaling=config.scaling,
                                compute_dtype=config.compute_dtype)

    absenv = new_env.abs()
    stats = torch.stack([
        absenv.max(),
        torch.where(absenv > 0, absenv, torch.inf).min(),
        samples.to(absenv.dtype).mean(),
    ])
    return SamplerState(new_env, key, log_scale + dlog), (samples, stats)


def sample_chain(mps: MPS, state: SamplerState,
                 config: SamplerConfig = SamplerConfig(),
                 start_site: int = 0) -> SampleResult:
    """Walk every site of ``mps``; ``start_site`` offsets the fold_in site
    indices so a resumed walk draws the randoms of the uninterrupted one."""
    samples, stats = [], []
    for i in range(mps.n_sites):
        state, (s, st) = site_step(
            state, (mps.gammas[i], mps.lambdas[i], start_site + i), config)
        samples.append(s)
        stats.append(st)
    return SampleResult(torch.stack(samples), state, torch.stack(stats))


def sample(mps: MPS, n_samples: int, key: torch.Tensor,
           config: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """User-facing: returns (N, M) outcomes."""
    state = init_state(mps, n_samples, key, config)
    return sample_chain(mps, state, config).samples.T


def sample_resumable(mps: MPS, state: SamplerState, start_site: int,
                     config: SamplerConfig = SamplerConfig()) -> SampleResult:
    """Resume mid-chain from a ``SamplerState`` saved at ``start_site``; the
    carried key reproduces the uninterrupted walk's draws (§4.1)."""
    rest = MPS(mps.gammas[start_site:], mps.lambdas[start_site:],
               mps.semantics)
    return sample_chain(rest, state, config, start_site=start_site)


def sample_batched(mps: MPS, n_samples: int, key: torch.Tensor,
                   micro_batch: int,
                   config: SamplerConfig = SamplerConfig()) -> torch.Tensor:
    """Split N into micro batches of N₂ (paper §3.1, Eq. 3) and walk them one
    after another; chunk j uses ``split(key, N/N₂)[j]``."""
    if micro_batch < 1 or n_samples % micro_batch != 0:
        raise ValueError(f"micro_batch={micro_batch} must divide "
                         f"n_samples={n_samples}")
    keys = prng.split(key, n_samples // micro_batch)
    outs = [sample(mps, micro_batch, k, config) for k in keys]
    return torch.cat(outs, dim=0)
