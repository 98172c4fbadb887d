"""Data-plane registry for :class:`repro_torch.api.SamplingSession`.

* ``inmem`` — the stacked Γ on the device: scheme ``seq`` walks it with
  ``core/sampler`` (micro-batched or not) or, with a χ-profile, with
  ``dynamic_bond``'s staged walk; ``dp``/``tp_*`` with ``core/parallel``'s
  segment runner over the session's mesh (with a χ-profile, one call per
  χ-stage after ``fit_env``), a TP rank holding only its tile of each Γ
  (``parallel.rank_chain``), and ``baseline19`` with the [19] ring; a
  clamped plan walks ``core/clamped.py`` in one χ-stage loop for every
  scheme and leaves the per-sample ``log_prob`` in the request's stats;
* ``streamed`` — ``engine.StreamingEngine`` walks the chain from a
  :class:`~repro_torch.data.gamma_store.GammaStore` in device-budgeted
  segments, with every scheme above, per-segment checkpoints and resume,
  on the session's runtime (on a multi-process runtime the root reads
  each segment and broadcasts it, paper §3.1);
* ``remote`` — no walk here: the request is serialized
  (``api/remote.py``) and dispatched through the runtime's ``submit``.

A (data plane × runtime) cell is config, not a class:
``SamplerConfig(backend="streamed", runtime="multihost")`` is the paper's
multi-host broadcast run.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.config import SessionPlan
from repro_torch.core.mps import MPS

_REGISTRY: dict[str, "Backend"] = {}


def register_backend(name: str) -> Callable[[type], type]:
    """Class decorator: instantiate and register a backend under ``name``."""
    def deco(cls: type) -> type:
        _REGISTRY[name] = cls()
        return cls
    return deco


def available_backends() -> list[str]:
    return sorted(_REGISTRY)


def get_backend(name: str) -> "Backend":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"no backend {name!r} registered; "
                         f"have {sorted(_REGISTRY)}") from None


@dataclasses.dataclass
class SampleRequest:
    """Everything a backend needs for one batch.  ``mps`` and ``store``
    are zero-argument callables, so a backend pays only for the source it
    walks (a streamed session never loads the chain, an in-memory one never
    writes a store).  ``runtime`` is the session's resolved runtime,
    ``config`` its session-level config (what the remote plane ships),
    ``job`` the ``service.JobBatch`` this request runs, and ``pipeline``
    whether the streamed engine fetches the next batch's first segment
    behind this batch's last one."""
    plan: SessionPlan
    n_samples: int
    key: torch.Tensor
    mps: Callable[[], MPS]
    store: Optional[Callable[[], object]] = None
    # the chain where the session keeps it (``mps`` is its copy on the
    # device) and the session's cache of this rank's TP tiles of it
    source: Optional[Callable[[], MPS]] = None
    tiles: Optional[dict] = None
    mesh: Optional[object] = None      # launch.mesh.Mesh for dp/tp/[19]
    resume: bool = False
    checkpoint_dir: Optional[str] = None
    stop_after_segments: Optional[int] = None
    stats: dict = dataclasses.field(default_factory=dict)
    engines: Optional[dict] = None     # the session's streamed engines
    runtime: Optional[object] = None   # api.runtime.ClusterRuntime
    config: Optional[object] = None    # api.config.SamplerConfig
    job: Optional[object] = None       # api.service.JobBatch
    pipeline: bool = False


class Backend:
    """One execution strategy for a resolved :class:`SessionPlan`."""
    name = "abstract"

    def sample(self, req: SampleRequest) -> np.ndarray:
        raise NotImplementedError


@register_backend("inmem")
class InMemBackend(Backend):
    """Whole chain on the device (paper §3.1–§3.2 in-memory paths)."""
    name = "inmem"

    def sample(self, req: SampleRequest) -> np.ndarray:
        from repro_torch.core import dynamic_bond as DB
        from repro_torch.core import parallel as PP
        from repro_torch.core import sampler as S

        plan, cfg, n, key = (req.plan, req.plan.sampler_config,
                             req.n_samples, req.key)
        if req.resume:
            raise ValueError("mid-chain resume needs the streamed backend "
                             "(it owns the per-segment checkpoints)")
        if plan.clamp is None and plan.scheme in ("tp_single", "tp_double"):
            return self._sample_tp(req)
        mps = req.mps()
        if plan.clamp is not None:
            return self._sample_clamped(req, mps)
        if plan.scheme == "seq":
            if plan.stages is not None:
                prof = np.asarray(plan.chi_profile)
                if plan.micro_batch is not None:
                    out = DB.sample_staged_batched(mps, prof, n, key,
                                                   plan.micro_batch, cfg)
                else:
                    out = DB.sample_staged(mps, prof, n, key, cfg)
            elif plan.micro_batch is not None:
                out = S.sample_batched(mps, n, key, plan.micro_batch, cfg)
            else:
                out = S.sample(mps, n, key, cfg)
        elif plan.scheme == "baseline19":
            out = PP._baseline19_sample(req.mesh, mps, n, key, cfg)
        elif plan.stages is None:
            out = PP._multilevel_sample(req.mesh, mps, n, key,
                                        plan.pconfig, cfg)
        else:
            # dynamic χ under dp: one segment-runner call per χ-stage, the
            # environment through fit_env at each boundary
            out = self._staged(req, lambda s0, s1, c: DB.stage_mps(
                mps, s0, s1, c), mps.gammas.dtype)
        return out.cpu().numpy()

    def _sample_tp(self, req: SampleRequest) -> np.ndarray:
        """tp_single / tp_double: each χ-stage (the whole chain without a
        profile) walks this rank's tiles, cut from the chain where the
        session keeps it and copied alone to the mesh's device, once a
        session (``req.tiles``)."""
        from repro_torch.core import parallel as PP

        plan = req.plan
        cache = req.tiles if req.tiles is not None else {}

        def tile(s0, s1, chi):
            k = (plan.scheme, s0, s1, chi)
            if k not in cache:
                src = (req.source or req.mps)()
                view = MPS(src.gammas[s0:s1, :chi, :chi],
                           src.lambdas[s0:s1, :chi], src.semantics)
                cache[k] = PP.rank_chain(req.mesh, view, plan.pconfig,
                                         req.mesh.device)
            return cache[k]

        if plan.stages is None:
            t = tile(0, None, None)
            out = PP._multilevel_sample(req.mesh, t, req.n_samples, req.key,
                                        plan.pconfig, plan.sampler_config)
        else:
            out = self._staged(req, tile, tile(*plan.stages[0]).dtype)
        return out.cpu().numpy()

    @staticmethod
    def _staged(req: SampleRequest, chain_of, gamma_dtype) -> torch.Tensor:
        """The χ-stage loop of a dp/tp plan: ``chain_of(s0, s1, χ)`` gives
        the stage's chain (an :class:`MPS` or a rank's tile), the segment
        runner walks it from the full environment after ``fit_env``.
        Returns the (N, M) outcomes."""
        from repro_torch.core import dynamic_bond as DB
        from repro_torch.core import parallel as PP

        plan, n = req.plan, req.n_samples
        env = PP.segment_env_init(n, plan.stages[0][2], gamma_dtype,
                                  req.mesh.device)
        log_scale, blocks = None, []
        for s0, s1, chi_s in plan.stages:
            env = DB.fit_env(env, chi_s)
            samples, env, log_scale = PP.sample_segment(
                req.mesh, chain_of(s0, s1, chi_s), env, req.key, s0,
                plan.pconfig, plan.sampler_config, log_scale=log_scale)
            blocks.append(samples)
        return torch.cat(blocks, dim=0).T

    def _sample_clamped(self, req: SampleRequest, mps: MPS) -> np.ndarray:
        """Conditional sampling: one χ-stage loop over the clamped segment
        runner for every scheme — seq the in-memory segment, dp the dp
        segment, tp_* the dp walk over the mesh's data axes
        (``clamped.dp_equivalent_pconfig``: every schedule draws the same
        samples per seed)."""
        from repro_torch.core import clamped as CL
        from repro_torch.core import dynamic_bond as DB
        from repro_torch.core import parallel as PP
        from repro_torch.workloads.clamp import (clamp_map,
                                                 segment_clamp_arrays)

        plan, cfg, n, key = (req.plan, req.plan.sampler_config,
                             req.n_samples, req.key)
        cmap = clamp_map(plan.clamp)
        pconf = (CL.dp_equivalent_pconfig(plan.pconfig)
                 if plan.pconfig is not None else None)
        stages = plan.stages or ((0, mps.n_sites, mps.chi),)
        env = PP.segment_env_init(n, stages[0][2], mps.gammas.dtype,
                                  mps.device)
        log_scale = log_prob = None
        blocks = []
        for s0, s1, chi_s in stages:
            seg = DB.stage_mps(mps, s0, s1, chi_s)
            env = DB.fit_env(env, chi_s)
            mask, vals = segment_clamp_arrays(cmap, s0, s1 - s0, n)
            if pconf is None:
                samples, env, log_scale, log_prob = CL.clamped_segment(
                    seg.gammas, seg.lambdas, env, key, s0, mask, vals, cfg,
                    log_scale=log_scale, log_prob=log_prob,
                    micro_batch=plan.micro_batch)
            else:
                samples, env, log_scale, log_prob = CL.sample_segment_clamped(
                    req.mesh, seg, env, key, s0, mask, vals, pconf, cfg,
                    log_scale=log_scale, log_prob=log_prob)
            blocks.append(samples)
        req.stats["log_prob"] = log_prob.cpu().numpy()
        return torch.cat(blocks, dim=0).T.cpu().numpy()


@register_backend("streamed")
class StreamedBackend(Backend):
    """Segment-streamed execution through :class:`engine.StreamingEngine`:
    one engine per constructor identity, kept for the session's life (a
    service's batches reuse it, and its pool fetches batch b+1's first
    segment behind batch b's last)."""
    name = "streamed"

    def sample(self, req: SampleRequest) -> np.ndarray:
        from repro_torch.engine.streaming import StreamingEngine, StreamPlan

        plan = req.plan
        store = req.store()
        scheme = "inmem" if plan.scheme == "seq" else plan.scheme
        shard = None
        if plan.shard_block:
            # the host count binds here, to the executing runtime: the same
            # plan on a lone remote worker walks the 1-host map locally
            from repro_torch.shard.shardmap import ShardMap
            n_hosts = (req.runtime.process_count
                       if req.runtime is not None else 1)
            shard = ShardMap(n_sites=store.n_sites, n_hosts=max(1, n_hosts),
                             block=plan.shard_block)

        def build() -> StreamingEngine:
            return StreamingEngine(
                store, semantics=plan.semantics, config=plan.sampler_config,
                plan=StreamPlan(segment_len=plan.segment_len, scheme=scheme,
                                micro_batch=plan.micro_batch,
                                checkpoint_every=plan.checkpoint_every),
                mesh=req.mesh if scheme != "inmem" else None,
                pconfig=plan.pconfig, chi_profile=plan.chi_profile,
                runtime=req.runtime, shard=shard, clamp=plan.clamp,
                device=plan.device)

        kw = dict(resume=req.resume,
                  stop_after_segments=req.stop_after_segments,
                  checkpoint_dir=req.checkpoint_dir)
        if req.engines is None:         # direct use: walk and release
            eng = build()
            try:
                out, stats = eng.sample_with_stats(req.n_samples, req.key,
                                                   **kw)
            finally:
                eng.close(close_store=False)
        else:
            # n_samples is not part of the key: batches of other sizes
            # share the engine and its pool thread
            eng_key = (scheme, plan.semantics, plan.segment_len,
                       plan.micro_batch, plan.chi_profile,
                       plan.checkpoint_every, plan.sampler_config,
                       plan.pconfig, plan.clamp, plan.device, shard)
            eng = req.engines.get(eng_key)
            if eng is None:
                new = build()
                eng = req.engines.setdefault(eng_key, new)   # a lost race
                if eng is not new:
                    new.close(close_store=False)
            out, stats = eng.sample_with_stats(req.n_samples, req.key,
                                               pipeline=req.pipeline, **kw)
        req.stats.update(stats)
        return out


@register_backend("remote")
class RemoteBackend(Backend):
    """Dispatch the serialized request through the runtime (no walk here):
    ``LocalRuntime`` runs it in this process, ``RemoteRuntime`` in a worker
    process.  The dispatch unit is the job batch: ``req.key`` is the job's
    key and ``req.job`` its identity, and the worker folds the batch key
    itself, so every batch equals its local counterpart."""
    name = "remote"

    def sample(self, req: SampleRequest) -> np.ndarray:
        from repro_torch.api.remote import build_payload

        if req.resume:
            raise ValueError("resume is local to the worker's checkpoint "
                             "dir — re-dispatch the batch instead (macro "
                             "batches are idempotent work items)")
        if req.checkpoint_dir is not None:
            raise ValueError("backend='remote' does not ship a "
                             "checkpoint_dir (see resolve_plan) — remote "
                             "fault tolerance is per macro batch")
        # the store is the hand-off: an MPS source is written once (its own
        # dtype) and only its location rides the payload
        store = req.store()
        payload = build_payload(req.config, store, req.n_samples, req.key,
                                job=req.job)
        before = dict(req.runtime.io_counters())
        out = req.runtime.submit(payload, device=req.plan.device)
        req.stats.update({f"runtime_{k}": v - before.get(k, 0)
                          for k, v in req.runtime.io_counters().items()
                          if isinstance(v, (int, float))
                          and not isinstance(v, bool)})
        return np.asarray(out)
