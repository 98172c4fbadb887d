"""Clamped (conditional) chain walks (``repro.core.clamped``).

A clamp fixes the outcome of a subset of sites (a ``workloads.clamp``
spec, carried as ``SamplerConfig.clamp``).  The walk is Alg. 1 with one
twist at each site::

    samples = where(mask_i, forced_outcome, inverse_cdf_draw)

The forced outcome goes into the collapse path, so the environment after a
clamped site is the conditional environment.  Site i's uniforms come from
``fold_in(key, i)`` whatever the other sites do, so forcing site i leaves
every other draw as it was: a clamped walk is the unclamped walk
conditioned on the clamped branch, without rejection.

The walk also accumulates the clamped branch's weight,

    log_prob[n] = Σ_{i ∈ clamp} ln P(s_i = clamp_i | s_{<i})

(natural log; unclamped sites add nothing), so ``w = exp(log_prob)`` makes
``Σ_n w_n·1{s_j^n = x} / Σ_n w_n`` an estimator of the conditional
marginals of every unclamped site j, and ``mean(w)`` one of the clamp's
probability.

The site body is the reference's: contract and measure, then draw, force,
gather and rescale.  A linear chain contracts and measures through the
dispatched ``contract_measure`` op, kernel 3 on the card
(``kernels/contract_measure.py``) and its plain version on the CPU; the
reference runs that op's xla cell (``contract_parallel`` +
``measure_probs_xla``) here.  A Born chain contracts with the plain complex
``contract_parallel``, as the port's Born TP steps do; it refuses
``compute_dtype``.  The fused site-step kernels cannot take a forced
outcome, so no clamped walk launches them.

Two placements, as in ``core/parallel.py``:

- :func:`clamped_segment` — the in-memory segment, whole or micro-batched
  (chunk keys ``split(key, n_micro)``, even for one chunk);
- :func:`sample_segment_clamped` — the dp segment over ``torch.distributed``:
  keys ``split(key, p₁)`` by data coordinate, the clamp's per-sample
  values sliced with the batch, ``log_prob`` a fourth carry, everything
  gathered over the data group.  TP plans run this dp walk over the mesh's
  data axes (:func:`dp_equivalent_pconfig`): every schedule draws the same
  samples per seed, so a clamped TP walk would emit the same outcomes.

An empty clamp never reaches this module: ``normalize_clamp`` turns it
into ``None`` and unclamped plans run the unchanged paths.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.core import prng
from repro_torch.core.mps import MPS
from repro_torch.core.parallel import (ParallelConfig, _shard, _take,
                                       _tp_rescale)
from repro_torch.core.precision import real_dtype_of
from repro_torch.core.sampler import SamplerConfig, init_state
from repro_torch.kernels import dispatch
from repro_torch.kernels.site_impls import (contract_parallel,
                                            draw_from_uniform,
                                            measure_probs_plain,
                                            site_probs_dtype)


def _contract_measure(env, gamma, lam, config: SamplerConfig):
    """(temp (N, R, d), probs (N, d)) of one site."""
    if config.semantics == "linear":
        backend = dispatch.resolve_kernels(config.kernels, env.device)
        op = dispatch.get_site_op("contract_measure", "linear", backend)
        return op(env, gamma, lam, semantics="linear",
                  compute_dtype=config.compute_dtype)
    if config.compute_dtype is not None:
        raise ValueError(
            "compute_dtype applies to linear chains: the clamped Born walk "
            "would round complex amplitudes to a real bf16")
    temp = contract_parallel(env, gamma, None)
    return temp, measure_probs_plain(temp, lam, "born")


def _clamped_site_update(env, gamma, lam, u, mask_i: bool, vals_i,
                         config: SamplerConfig):
    """One site: contract → measure → (draw | force) → collapse → rescale.

    ``mask_i`` is the host's bool for the site and ``vals_i`` (N,) its
    forced outcomes.  Returns ``(env', samples, dlog_scale, dlog_prob)``,
    ``dlog_prob`` being ``ln P(s_i | s_{<i})`` on a clamped site and 0
    elsewhere."""
    temp, probs = _contract_measure(env, gamma, lam, config)
    samples = draw_from_uniform(probs, u)
    if mask_i:
        samples = vals_i
    env_new = _take(temp, samples)
    if config.semantics == "born":
        env_new = env_new * lam[None, :]
    env_new, dlog = _tp_rescale(env_new, config.scaling)

    rdt = real_dtype_of(env.dtype)
    if not mask_i:
        return env_new, samples, dlog, torch.zeros(
            (env.shape[0],), dtype=rdt, device=env.device)
    total = probs.sum(dim=1).to(rdt)
    psel = torch.take_along_dim(probs, samples[:, None], dim=1)[:, 0].to(rdt)
    cond = torch.clamp(psel / total, min=torch.finfo(rdt).tiny)
    return env_new, samples, dlog, torch.log(cond)


def _chain(gammas, lambdas, env, key, log_scale, log_prob, mask, vals,
           config: SamplerConfig, start_site: int):
    """Sites [start, start + L): the clamped twin of ``sample_chain``.
    Site i draws its uniforms from ``fold_in(key, i)`` in the dispatch
    layer's dtype, the stream every unclamped schedule consumes.  ``vals``
    is an (L, n) int64 tensor on env's device.  Returns (samples (L, n),
    env', log_scale', log_prob')."""
    samples = []
    for i in range(gammas.shape[0]):
        g, lam = gammas[i], lambdas[i]
        u = prng.uniform(
            prng.fold_in(key, start_site + i), (env.shape[0], 1),
            dtype=site_probs_dtype(env, g, lam, config.semantics,
                                   config.compute_dtype),
            device=env.device)
        env, smp, dlog, dlogp = _clamped_site_update(
            env, g, lam, u, bool(mask[i]), vals[i], config)
        log_scale = log_scale + dlog
        log_prob = log_prob + dlogp.to(log_prob.dtype)
        samples.append(smp)
    return torch.stack(samples), env, log_scale, log_prob


def _walk(gammas, lambdas, env, key, log_scale, log_prob, mask, vals,
          config, start: int, micro_batch: Optional[int]):
    """The batch whole, or as n/N₂ chunks on ``split(key, n/N₂)`` (even
    when that is one chunk: its key is ``split(key, 1)[0]``, not key)."""
    if micro_batch is None:
        return _chain(gammas, lambdas, env, key, log_scale, log_prob, mask,
                      vals, config, start)
    outs = []
    for c, k in enumerate(prng.split(key, env.shape[0] // micro_batch)):
        rows = slice(c * micro_batch, (c + 1) * micro_batch)
        outs.append(_chain(gammas, lambdas, env[rows], k, log_scale[rows],
                           log_prob[rows], mask, vals[:, rows], config,
                           start))
    return tuple(torch.cat([o[j] for o in outs], dim=1 if j == 0 else 0)
                 for j in range(4))


def _carries(env, log_scale, log_prob):
    """The (N,) carries, zero where not given (never updated in place)."""
    zeros = torch.zeros((env.shape[0],), dtype=real_dtype_of(env.dtype),
                        device=env.device)
    return (zeros if log_scale is None else log_scale,
            zeros if log_prob is None else log_prob)


def _clamp_operands(mask, vals, device):
    mask = np.asarray(mask, dtype=bool)
    vals = torch.as_tensor(np.asarray(vals, dtype=np.int64), device=device)
    if vals.shape[0] != mask.shape[0]:
        raise ValueError(f"clamp arrays cover {mask.shape[0]} and "
                         f"{vals.shape[0]} sites")
    return mask, vals


def clamped_segment(gammas, lambdas, env, key, start_site, mask, vals,
                    config: SamplerConfig,
                    log_scale: Optional[torch.Tensor] = None,
                    log_prob: Optional[torch.Tensor] = None,
                    micro_batch: Optional[int] = None):
    """Run one clamped in-memory segment from a full (N, χ) environment.

    ``mask (L,) bool`` / ``vals (L, N)`` come from
    ``workloads.clamp.segment_clamp_arrays``.  Returns ``(samples (L, N),
    env', log_scale', log_prob')``."""
    n = env.shape[0]
    log_scale, log_prob = _carries(env, log_scale, log_prob)
    mask, vals = _clamp_operands(mask, vals, env.device)
    if micro_batch is not None and (micro_batch < 1 or n % micro_batch):
        raise ValueError(f"micro_batch={micro_batch} must divide "
                         f"n_samples={n}")
    return _walk(gammas, lambdas, env, key, log_scale, log_prob, mask, vals,
                 config, int(start_site), micro_batch)


def sample_clamped(mps: MPS, n_samples: int, key: torch.Tensor,
                   config: SamplerConfig, mask, vals,
                   micro_batch: Optional[int] = None):
    """Whole-chain clamped walk.  Returns ``(samples (N, M), log_prob
    (N,))``."""
    state = init_state(mps, n_samples, key, config)
    samples, _, _, log_prob = clamped_segment(
        mps.gammas, mps.lambdas, state.env, state.key, 0, mask, vals,
        config, log_scale=state.log_scale, micro_batch=micro_batch)
    return samples.T, log_prob


def sample_segment_clamped(mesh, mps: MPS, env: torch.Tensor,
                           key: torch.Tensor, start_site, mask, vals,
                           pconfig: ParallelConfig, config: SamplerConfig,
                           log_scale: Optional[torch.Tensor] = None,
                           log_prob: Optional[torch.Tensor] = None):
    """Clamped twin of ``parallel.sample_segment``, dp placement only
    (:func:`dp_equivalent_pconfig` maps a TP plan onto it).  ``env``,
    ``log_scale``, ``log_prob`` and ``vals`` are the full arrays, the same
    on every rank; every rank returns the full ``(samples (L, N), env',
    log_scale', log_prob')``, gathered over the data group only (the model
    ranks of a data shard walk the same shard)."""
    if pconfig.scheme != "dp":
        raise ValueError(f"the clamped segment runs the dp placement; got "
                         f"{pconfig.scheme!r} (see dp_equivalent_pconfig)")
    # several data axes ("pod", "data") split the batch over their
    # flattened line, pod-major
    data = mesh.group(pconfig.data_axes)
    p1, me = C.axis_size(data), C.axis_index(data)
    n = env.shape[0]
    if n % p1:
        raise ValueError(f"n_samples={n} must divide over the p₁={p1} data "
                         f"shards")
    n_local = n // p1
    if pconfig.micro_batch is not None and n_local % pconfig.micro_batch:
        raise ValueError(f"micro_batch={pconfig.micro_batch} must divide "
                         f"the local batch {n_local}")
    log_scale, log_prob = _carries(env, log_scale, log_prob)
    mask, vals = _clamp_operands(mask, vals, env.device)
    shard_key = prng.split(key, p1)[me]
    samples, env_o, ls_o, lp_o = _walk(
        mps.gammas, mps.lambdas, _shard(env, data, 0).contiguous(),
        shard_key, _shard(log_scale, data, 0).contiguous(),
        _shard(log_prob, data, 0).contiguous(), mask,
        vals[:, me * n_local:(me + 1) * n_local], config, int(start_site),
        pconfig.micro_batch)
    return (C.all_gather(samples, data, dim=1), C.all_gather(env_o, data),
            C.all_gather(ls_o, data), C.all_gather(lp_o, data))


def dp_equivalent_pconfig(pconfig: ParallelConfig) -> ParallelConfig:
    """The dp placement a clamped TP plan walks: the batch sharded over the
    same data axes, the model axis left replicated.  Every schedule draws
    the same randoms per (shard, site), so the clamped dp walk emits what a
    clamped TP walk would."""
    if pconfig.scheme == "dp":
        return pconfig
    return ParallelConfig(scheme="dp", data_axes=pconfig.data_axes,
                          model_axis=pconfig.model_axis,
                          micro_batch=pconfig.micro_batch)


__all__ = ["clamped_segment", "dp_equivalent_pconfig", "sample_clamped",
           "sample_segment_clamped"]
