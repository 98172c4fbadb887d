"""Multi-level parallel MPS sampling (paper §3.1–3.2) and the [19] baseline,
over ``torch.distributed``.

Mesh layout (``launch/mesh.py``): axes ("data", "model"), p = p₁ × p₂.

* **Data parallel** (§3.1): each of the p₁ data groups owns N/p₁ samples and
  walks the whole chain; Γ is replicated.
* **Tensor parallel** (§3.2): within a group, Γᵢ and the environment are
  split along the bond χ over p₂ ranks.

  - ``tp_single``: split-K GEMM over the left bond.  Linear chains measure
    before they communicate: a psum of the (N, d) partial probs, then a
    psum_scatter of the collapsed (N, χ) environment.  Born chains must sum
    before squaring (|Σ·|² ≠ Σ|·|²), so they psum_scatter the unmeasured
    (N, χ, d) temp.  ``measure_first`` (linear only) draws from
    ``env @ W`` with ``W = Γ·Λ`` and collapses with a sample-selected GEMM,
    so the (N, χ, d) temp never exists.
  - ``tp_double``: one psum of the unmeasured (N, χ, d) temp every two
    sites; the even site's Γ is split along the right bond, so its GEMM
    needs no collective.

All schemes draw the same randoms within a TP group (the key is replicated
over "model"), so dp and both TP schedules give the same samples for the
same seed — the JAX package's promise, which the tests hold the port to.

The JAX package runs this under ``shard_map`` from one controller; the port
runs SPMD: every rank executes this module's Python on its own shard, the
``lax.scan`` loops are Python loops over sites, and the collectives are
those of ``core/collectives.py`` on the mesh's process groups.  A TP rank
walks a :class:`ChainTile`, only its tile of each Γ (the ``shard_map``
``in_specs``; :func:`shard_chain` cuts it from a whole chain and copies it
alone to the card); dp keeps Γ whole.  By default every rank returns the
full result, as the JAX controller does; ``sharded=True`` keeps it sharded
as the ``out_specs`` do (samples and ``log_scale`` over the data axes, env
over data × model), with no all-gather at the end.  The key schedule is
the JAX package's: ``split(key, p₁)`` indexed by the data coordinate,
``fold_in(k, start + site)`` per site (per pair ``start + 2j`` and
``start + 2j + 1``), and ``split(shard_key, n_micro)`` per micro batch.

The per-site stages go through ``kernels/dispatch.py``: ``contract_measure``,
``measure`` and ``collapse`` (the Hopper kernels with ``kernels="cuda"``),
and the fused ``site_step`` for dp.  The Born TP paths stay plain PyTorch,
as they stay XLA in the JAX package by design.

``SamplerConfig.compute_dtype`` (bf16 GEMM inputs, fp32 sums) reaches every
linear stage; a bf16-stored Γ gets an fp32 environment.  The Born TP
schedules refuse it (``site_impls.contract_parallel``), and the [19]
baseline ignores it and walks in Γ's own dtype, as the JAX package's does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import collectives as C
from repro_torch.core import prng
from repro_torch.core import sampler as S
from repro_torch.core.mps import MPS, TP_SCHEMES
from repro_torch.core.precision import real_dtype_of
from repro_torch.kernels import dispatch
from repro_torch.kernels.site_impls import (contract_parallel,
                                            draw_from_uniform,
                                            measure_probs_plain)


def _env_dtype(gamma_dtype: torch.dtype) -> torch.dtype:
    """Environments accumulate across sites: never below fp32 (§3.3.2)."""
    return (torch.float32 if gamma_dtype in (torch.bfloat16, torch.float16)
            else gamma_dtype)


def draw_from_probs(probs: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Alg. 1 lines 2-4 with the uniforms of ``key`` (``sampler``'s
    ``draw_from_probs`` in the JAX package)."""
    u = prng.uniform(key, (probs.shape[0], 1), dtype=probs.dtype,
                     device=probs.device)
    return draw_from_uniform(probs, u)


def _take(temp: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """temp[n, :, s_n]: collapse the physical leg at the drawn outcome."""
    return torch.take_along_dim(temp, samples[:, None, None], dim=2)[:, :, 0]


def _shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's tile of ``x`` along ``dim`` (p equal tiles)."""
    w = x.shape[dim] // C.axis_size(group)
    return x.narrow(dim, C.axis_index(group) * w, w)


@dataclasses.dataclass(frozen=True)
class ChainTile:
    """One TP rank's share of a chain segment: its tile of each Γ
    (``core.mps.site_tile``) and the whole Λ (replicated, as the JAX
    package's ``P()``).  ``tp_single``: ``gammas`` (L, χ/p₂, χ, d), rows of
    every site.  ``tp_double``: ``gammas`` (L/2, χ/p₂, χ, d), rows of the
    sites 2j, and ``gammas_right`` (L/2, χ, χ/p₂, d), the right-bond columns
    of the sites 2j + 1."""
    gammas: torch.Tensor
    lambdas: torch.Tensor            # (L, χ)
    semantics: str
    scheme: str
    p2: int
    rank: int
    gammas_right: Optional[torch.Tensor] = None

    @property
    def n_sites(self) -> int:
        return self.lambdas.shape[0]

    @property
    def chi(self) -> int:
        return self.lambdas.shape[1]

    @property
    def device(self) -> torch.device:
        return self.gammas.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gammas.dtype


def shard_chain(mps: MPS, scheme: str, p2: int, rank: int,
                device=None) -> ChainTile:
    """Rank ``rank``'s :class:`ChainTile` of ``mps`` under ``scheme`` over p₂
    ranks, on ``device`` (default: where ``mps`` lies).  The tiles are cut
    where ``mps`` lies and only they are copied: a chain held on the host
    puts 1/p₂ of each Γ on the card.  On ``mps``'s own device they are
    views (the walk makes each site's tile contiguous as it reaches it)."""
    if scheme not in TP_SCHEMES:
        raise ValueError(f"{scheme!r} has no tiles (one of {TP_SCHEMES})")
    if mps.chi % p2:
        raise ValueError(f"χ={mps.chi} does not divide over p₂={p2} ranks")
    if not 0 <= rank < p2:
        raise ValueError(f"rank {rank} is not one of p₂={p2}")
    dev = mps.device if device is None else torch.device(device)
    w = mps.chi // p2
    g, right = mps.gammas, None
    if scheme == "tp_double":
        if mps.n_sites % 2:
            raise ValueError("double-site segments need an even site count")
        g, right = g[0::2], g[1::2].narrow(2, rank * w, w).to(dev)
    return ChainTile(g.narrow(1, rank * w, w).to(dev), mps.lambdas.to(dev),
                     mps.semantics, scheme, p2, rank, right)


def rank_chain(mesh, mps: MPS, pconfig: "ParallelConfig", device=None):
    """What this rank of ``mesh`` walks of ``mps`` under ``pconfig``: the
    whole chain under dp (on ``device``), its :class:`ChainTile` under a TP
    scheme (:func:`shard_chain`)."""
    if pconfig.scheme not in TP_SCHEMES:
        return mps if device is None else mps.to(device)
    model = mesh.group(pconfig.model_axis)
    return shard_chain(mps, pconfig.scheme, C.axis_size(model),
                       C.axis_index(model), device)


def _chain_tile(chain, scheme: str, group) -> ChainTile:
    """``chain`` as this rank's :class:`ChainTile` (a whole :class:`MPS` is
    cut in place, with no copy); a given tile must be this rank's."""
    p2, rank = C.axis_size(group), C.axis_index(group)
    if isinstance(chain, MPS):
        return shard_chain(chain, scheme, p2, rank)
    if (chain.scheme, chain.p2, chain.rank) != (scheme, p2, rank):
        raise ValueError(f"a {chain.scheme} tile of rank {chain.rank}/"
                         f"{chain.p2} given to rank {rank}/{p2} of "
                         f"{scheme}")
    return chain


def _backend(config: S.SamplerConfig, env: torch.Tensor) -> str:
    return dispatch.resolve_kernels(config.kernels, env.device)


def _tp_rescale(env: torch.Tensor, mode: str, group=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Adaptive rescale of a (possibly bond-sharded) environment: the max is
    taken across the TP group (pmax) when the environment is sharded, so
    every shard divides by the same factor.  Returns (env', per-sample
    log10 factor)."""
    rdt = real_dtype_of(env.dtype)
    n = env.shape[0]
    if mode == "none":
        return env, torch.zeros((n,), dtype=rdt, device=env.device)
    a = env.abs()
    if mode == "per_sample":
        m = a.amax(dim=1, keepdim=True)
        if group is not None:
            m = C.pmax(m, group)
        factor = torch.where(m > 0, m, 1.0).to(rdt)
        return env / factor, torch.log10(factor[:, 0])
    if mode == "global":
        m = a.max().reshape(1)
        if group is not None:
            m = C.pmax(m, group)
        factor = torch.where(m > 0, m, 1.0).to(rdt)
        return env / factor, torch.log10(factor).expand(n)
    raise ValueError(f"unknown scaling mode: {mode}")


# ---------------------------------------------------------------------------
# Tensor parallel — single-site (ReduceScatter) schedule
# ---------------------------------------------------------------------------

def _tp_single_site_step(env, gamma_l, lam, key, config, group,
                         wire_dtype=None):
    """One site with env (N, χ/p₂) and Γ sharded on the left bond.
    Returns (new sharded env, per-sample log10 rescale factor, samples)."""
    semantics = config.semantics
    dtype = env.dtype
    if semantics == "linear":
        # contract + partial measure in one dispatched op, then
        # measure-before-communicate: a psum of the (N, d) partial probs
        cm = dispatch.get_site_op("contract_measure", semantics,
                                  _backend(config, env))
        temp_partial, probs_partial = cm(env, gamma_l, lam,
                                         semantics=semantics,
                                         compute_dtype=config.compute_dtype)
        probs = C.psum(probs_partial, group)
        samples = draw_from_probs(probs, key)
        collapsed = _take(temp_partial, samples)          # (N, χ) partial
        if wire_dtype is not None:
            collapsed = collapsed.to(wire_dtype)
        env_new = C.psum_scatter(collapsed, group).to(dtype)   # (N, χ/p₂)
    else:
        # born: sum the split-K partials before squaring
        temp_partial = contract_parallel(env, gamma_l, config.compute_dtype)
        temp = C.psum_scatter(temp_partial, group)        # (N, χ/p₂, d)
        lam_shard = _shard(lam, group, 0)
        probs = C.psum(measure_probs_plain(temp, lam_shard, semantics), group)
        samples = draw_from_probs(probs, key)
        env_new = _take(temp, samples) * lam_shard[None, :]
    env_new, dlog = _tp_rescale(env_new, config.scaling, group)
    return env_new, dlog, samples


def _tp_single_site_step_measure_first(env, gamma_l, w_l, key, config, group,
                                       wire_dtype=None):
    """tp-3: probs from the small env@W GEMM; collapse by the select-GEMM.
    env (N, χ/p₂) sharded; gamma_l (χ/p₂, χ, d); w_l (χ/p₂, d)."""
    dtype = env.dtype
    backend = _backend(config, env)
    measure_op = dispatch.get_site_op("measure", "linear", backend)
    collapse_op = dispatch.get_site_op("collapse", "linear", backend)
    probs = C.psum(measure_op(env, w_l, compute_dtype=config.compute_dtype)
                   .to(dtype), group)
    samples = draw_from_probs(probs, key)
    collapsed = collapse_op(env, gamma_l, samples,
                            compute_dtype=config.compute_dtype)   # (N, χ)
    if wire_dtype is not None:
        collapsed = collapsed.to(wire_dtype)
    env_new = C.psum_scatter(collapsed, group).to(dtype)
    env_new, dlog = _tp_rescale(env_new, config.scaling, group)
    return env_new, dlog, samples


# ---------------------------------------------------------------------------
# Tensor parallel — double-site (AllReduce) schedule
# ---------------------------------------------------------------------------

def _tp_double_site_pair(env, gamma_odd_l, lam_odd, gamma_even_r, lam_even,
                         key_pair, config, group, wire_dtype=None):
    """Two sites per round: one all-reduce, the even site collective-free."""
    semantics = config.semantics
    k_odd, k_even = key_pair
    backend = _backend(config, env)
    fused = backend == "cuda" and semantics == "linear"

    # --- odd site: split-K over the left bond, all-reduce the unmeasured temp
    if fused and wire_dtype is None:
        # the kernel's partial probs are summed beside the temp (measurement
        # is linear); with a wire_dtype the plain path measures the
        # wire-rounded sum, which partial probs cannot reproduce
        cm = dispatch.get_site_op("contract_measure", semantics, backend)
        temp, probs_partial = cm(env, gamma_odd_l, lam_odd,
                                 semantics=semantics,
                                 compute_dtype=config.compute_dtype)
        temp = C.psum(temp, group).to(env.dtype)          # (N, χ, d) full
        probs = C.psum(probs_partial, group)
    else:
        temp = contract_parallel(env, gamma_odd_l, config.compute_dtype)
        if wire_dtype is not None:
            temp = temp.to(wire_dtype)
        temp = C.psum(temp, group).to(env.dtype)          # (N, χ, d) full
        probs = measure_probs_plain(temp, lam_odd, semantics)  # replicated
    samples_odd = draw_from_probs(probs, k_odd)
    env_full = _take(temp, samples_odd)
    if semantics == "born":
        env_full = env_full * lam_odd[None, :]
    # a full (replicated) environment: every shard computes the same max
    env_full, dlog_odd = _tp_rescale(env_full, config.scaling)

    # --- even site: Γ split on the right bond; local GEMM, no collective
    lam_shard = _shard(lam_even, group, 0)
    if fused:
        cm = dispatch.get_site_op("contract_measure", semantics, backend)
        temp_loc, probs_partial = cm(env_full, gamma_even_r, lam_shard,
                                     semantics=semantics,
                                     compute_dtype=config.compute_dtype)
        probs = C.psum(probs_partial, group)              # (N, d)
    else:
        temp_loc = contract_parallel(env_full, gamma_even_r,
                                     config.compute_dtype)  # (N, χ/p₂, d)
        probs = C.psum(measure_probs_plain(temp_loc, lam_shard, semantics),
                       group)
    samples_even = draw_from_probs(probs, k_even)
    env_new = _take(temp_loc, samples_even)
    if semantics == "born":
        env_new = env_new * lam_shard[None, :]
    env_new, dlog_even = _tp_rescale(env_new, config.scaling, group)
    return env_new, dlog_odd + dlog_even, (samples_odd, samples_even)


# ---------------------------------------------------------------------------
# Top-level multi-level sampler
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    scheme: str = "dp"           # "dp" | "tp_single" | "tp_double" | "baseline19"
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    # cast the collapsed environment to this dtype before the big collective
    # (bf16 keeps fp32's exponent range: with per-sample scaling the cast
    # only rounds the mantissa)
    wire_dtype: Optional[torch.dtype] = None
    # measure-first (linear only): probs = env @ (Γ·Λ), collapse by a
    # sample-selected GEMM; the (N, χ, d) temp never exists
    measure_first: bool = False
    # §3.1 micro batching N₂ per data shard, with chunk keys
    # split(shard_key, n_micro) — the ``sampler.sample_batched`` schedule
    micro_batch: Optional[int] = None


def _multilevel_sample(mesh, mps, n_samples: int, key: torch.Tensor,
                       pconfig: ParallelConfig = ParallelConfig(),
                       config: S.SamplerConfig = S.SamplerConfig(),
                       *, sharded: bool = False) -> torch.Tensor:
    """DP over samples × TP over χ: the segment runner over the whole chain
    as one segment.  ``mps``: the whole chain, or under a TP scheme this
    rank's :class:`ChainTile`.  Returns (N, M) outcomes on every rank or,
    with ``sharded``, this data shard's (N/p₁, M), its environment made
    as its own tile alone."""
    if pconfig.scheme == "baseline19":
        return _baseline19_sample(mesh, mps, n_samples, key, config,
                                  pipeline_axis=pconfig.data_axes[-1])
    if pconfig.scheme not in ("dp", "tp_single", "tp_double"):
        raise ValueError(f"unknown scheme {pconfig.scheme!r}")
    if sharded:
        env = segment_env_shard(mesh, pconfig, n_samples, mps.chi,
                                mps.gammas.dtype, mps.device)
    else:
        env = segment_env_init(n_samples, mps.chi, mps.gammas.dtype,
                               mps.device)
    samples, _, _ = sample_segment(mesh, mps, env, key, 0, pconfig, config,
                                   sharded=sharded)
    return samples.T


def _with_micro(chain_fn, base, env_l, ls_l, n2: Optional[int]):
    """Run the shard's batch through ``chain_fn`` whole, or as n_local/N₂
    chunks with keys split(shard_key, n_micro) — the in-memory batched
    sampler's schedule.  Returns (samples (L, n), env (n, ·), log_scale)."""
    if n2 is None:
        return chain_fn(base, env_l, ls_l)
    keys = prng.split(base, env_l.shape[0] // n2)
    outs = [chain_fn(k, env_l[c * n2:(c + 1) * n2], ls_l[c * n2:(c + 1) * n2])
            for c, k in enumerate(keys)]
    return (torch.cat([o[0] for o in outs], dim=1),
            torch.cat([o[1] for o in outs], dim=0),
            torch.cat([o[2] for o in outs], dim=0))


def _dp_chain(mps: MPS, start: int, config):
    def chain(k, e, ls):
        state = S.SamplerState(e, k, ls)
        samples = []
        for i in range(mps.n_sites):
            state, (smp, _) = S.site_step(
                state, (mps.gammas[i], mps.lambdas[i], start + i), config)
            samples.append(smp)
        return torch.stack(samples), state.env, state.log_scale
    return chain


def _tp_single_chain(tile: ChainTile, start: int, config, pconfig, group):
    measure_first = pconfig.measure_first and config.semantics == "linear"
    if measure_first:
        # W per site in fp32, as the JAX package builds it
        w_l = [torch.einsum("lrs,r->ls", tile.gammas[i].to(torch.float32),
                            tile.lambdas[i].to(torch.float32))
               for i in range(tile.n_sites)]

    def chain(k, e, ls):
        samples = []
        for i in range(tile.n_sites):
            g = tile.gammas[i].contiguous()
            sub = prng.fold_in(k, start + i)
            if measure_first:
                e, dlog, smp = _tp_single_site_step_measure_first(
                    e, g, w_l[i], sub, config, group,
                    wire_dtype=pconfig.wire_dtype)
            else:
                e, dlog, smp = _tp_single_site_step(
                    e, g, tile.lambdas[i], sub, config, group,
                    wire_dtype=pconfig.wire_dtype)
            ls = ls + dlog
            samples.append(smp)
        return torch.stack(samples), e, ls
    return chain


def _tp_double_chain(tile: ChainTile, start: int, config, pconfig, group):
    def chain(k, e, ls):
        samples = []
        for j in range(tile.n_sites // 2):
            kp = (prng.fold_in(k, start + 2 * j),
                  prng.fold_in(k, start + 2 * j + 1))
            e, dlog, (so, se) = _tp_double_site_pair(
                e, tile.gammas[j].contiguous(), tile.lambdas[2 * j],
                tile.gammas_right[j].contiguous(), tile.lambdas[2 * j + 1],
                kp, config, group, wire_dtype=pconfig.wire_dtype)
            ls = ls + dlog
            samples += [so, se]
        return torch.stack(samples), e, ls
    return chain


def sample_segment(mesh, mps, env: torch.Tensor, key: torch.Tensor,
                   start_site: int,
                   pconfig: ParallelConfig = ParallelConfig(),
                   config: S.SamplerConfig = S.SamplerConfig(),
                   log_scale: Optional[torch.Tensor] = None,
                   *, sharded: bool = False
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run sites [start, start+L) of the chain from an environment.

    ``mps`` holds only the segment's L sites: the whole :class:`MPS`, or
    under a TP scheme this rank's :class:`ChainTile` (a whole chain is cut
    in place).  By default ``env`` (N, χ) and ``log_scale`` (N,) are the
    full arrays, the same on every rank, and so is the result (samples (L,
    N) site-major, env' (N, χ), log_scale' (N,)).  With ``sharded`` they
    are this rank's shards, in and out: env (N/p₁, χ/p₂) under TP, (N/p₁,
    χ) under dp, log_scale (N/p₁,), samples (L, N/p₁); no all-gather ends
    the segment.  ``log_scale=None`` starts the carry at zero.
    """
    # several data axes ("pod", "data") split the batch over their
    # flattened line, pod-major
    data = mesh.group(pconfig.data_axes)
    p1 = C.axis_size(data)
    n_rows, chi = env.shape
    if log_scale is None:
        log_scale = torch.zeros((n_rows,), dtype=real_dtype_of(env.dtype),
                                device=env.device)
    if sharded:
        env_l, ls_l = env, log_scale
    else:
        if n_rows % p1:
            raise ValueError(f"n_samples={n_rows} must divide over the "
                             f"p₁={p1} data shards")
        env_l, ls_l = _shard(env, data, 0), _shard(log_scale, data, 0)
    if pconfig.micro_batch is not None and \
            env_l.shape[0] % pconfig.micro_batch:
        raise ValueError(f"micro_batch={pconfig.micro_batch} must divide "
                         f"the local batch {env_l.shape[0]}")
    start = int(start_site)
    shard_key = prng.split_at(key, p1, C.axis_index(data))

    if pconfig.scheme == "dp":
        chain = _dp_chain(mps, start, config)
        model = None
    elif pconfig.scheme in TP_SCHEMES:
        model = mesh.group(pconfig.model_axis)
        tile = _chain_tile(mps, pconfig.scheme, model)
        if tile.chi % C.axis_size(model):
            raise ValueError(f"χ={tile.chi} does not divide over "
                             f"p₂={C.axis_size(model)} ranks")
        if not sharded:
            env_l = _shard(env_l, model, 1)
        make = (_tp_single_chain if pconfig.scheme == "tp_single"
                else _tp_double_chain)
        chain = make(tile, start, config, pconfig, model)
    else:
        raise ValueError(f"segment runner has no scheme {pconfig.scheme!r}")

    samples, env_o, ls_o = _with_micro(chain, shard_key, env_l.contiguous(),
                                       ls_l.contiguous(), pconfig.micro_batch)
    if sharded:
        return samples, env_o, ls_o
    if model is not None:
        env_o = C.all_gather(env_o, model, dim=1)
    return (C.all_gather(samples, data, dim=1), C.all_gather(env_o, data),
            C.all_gather(ls_o, data))


def segment_env_init(n_samples: int, chi: int, gamma_dtype: torch.dtype,
                     device) -> torch.Tensor:
    """Boundary environment for site 0: one-hot row 0, the full view."""
    env = torch.zeros((n_samples, chi), dtype=_env_dtype(gamma_dtype),
                      device=device)
    # fill_, not ``env[:, 0] = 1.0``: indexing assignment makes its scalar a
    # real tensor on the device, even under the dry run's fake tensors
    env[:, 0].fill_(1.0)
    return env


def segment_env_shard(mesh, pconfig: ParallelConfig, n_samples: int,
                      chi: int, gamma_dtype: torch.dtype,
                      device) -> torch.Tensor:
    """This rank's shard of :func:`segment_env_init`'s environment, made
    alone: (N/p₁, χ/p₂) under TP (the hot column 0 on model rank 0), (N/p₁,
    χ) under dp — the ``sharded`` input of :func:`sample_segment`."""
    p1 = C.axis_size(mesh.group(pconfig.data_axes))
    if n_samples % p1:
        raise ValueError(f"n_samples={n_samples} must divide over the "
                         f"p₁={p1} data shards")
    hot = True
    if pconfig.scheme in TP_SCHEMES:
        model = mesh.group(pconfig.model_axis)
        chi //= C.axis_size(model)
        hot = C.axis_index(model) == 0
    env = torch.zeros((n_samples // p1, chi), dtype=_env_dtype(gamma_dtype),
                      device=device)
    if hot:
        env[:, 0].fill_(1.0)
    return env


# ---------------------------------------------------------------------------
# Baseline [19]: one rank per site, macro-batch pipeline over a ring
# ---------------------------------------------------------------------------

def _baseline19_sample(mesh, mps: MPS, n_samples: int, key: torch.Tensor,
                       config: S.SamplerConfig = S.SamplerConfig(),
                       pipeline_axis: str = "data",
                       n_macro: Optional[int] = None) -> torch.Tensor:
    """The model-parallel scheme of [19] (Fig. 2), for comparison.

    p ranks = M sites.  The left environment of each macro batch flows down
    a ring of ``ppermute``s; at step t, rank i walks macro batch t − i, so
    the run takes n₁ + M − 1 steps (the pipeline fill the paper criticises).
    Rank i draws site i of batch b with ``fold_in(split(key, n₁)[b], i)`` —
    the data-parallel schedule, so both give the same samples.  Returns
    (N, M) outcomes on every rank.
    """
    group = mesh.group(pipeline_axis)
    p, M = C.axis_size(group), mps.n_sites
    if p != M:
        raise ValueError(f"[19] binds one rank per site (p={p}, M={M})")
    n1 = n_macro or config_macro_batches(n_samples)
    if n_samples % n1:
        raise ValueError(f"n_samples={n_samples} must divide over "
                         f"{n1} macro batches")
    n_batch = n_samples // n1
    i = C.axis_index(group)
    base_keys = prng.split(key, n1)
    gamma, lam = mps.gammas[i], mps.lambdas[i]
    fresh = torch.zeros((n_batch, gamma.shape[0]), dtype=gamma.dtype,
                        device=gamma.device)
    fresh[:, 0] = 1.0
    ring = [(j, (j + 1) % M) for j in range(M)]

    env_in, emitted = fresh, []
    for t in range(n1 + M - 1):
        b = t - i                        # the macro batch at this rank now
        send = env_in
        if 0 <= b < n1:
            temp = torch.einsum("nl,lrs->nrs", env_in, gamma)
            probs = measure_probs_plain(temp, lam, mps.semantics)
            s = draw_from_probs(probs, prng.fold_in(base_keys[b], i))
            env_out = _take(temp, s)
            if mps.semantics == "born":
                env_out = env_out * lam[None, :]
            m = env_out.abs().amax(dim=1, keepdim=True)
            send = env_out / torch.where(m > 0, m, 1.0)
            emitted.append(s)
        nxt = C.ppermute(send, group, ring)
        env_in = fresh if i == 0 else nxt   # fresh batches enter at rank 0
    out = C.all_gather(torch.stack(emitted)[None], group)   # (M, n1, N1)
    return out.permute(1, 2, 0).reshape(n_samples, M)


def config_macro_batches(n_samples: int, target: int = 4) -> int:
    """n₁: the number of macro batches (small, for the CPU tests)."""
    for n1 in range(target, 0, -1):
        if n_samples % n1 == 0:
            return n1
    return 1
