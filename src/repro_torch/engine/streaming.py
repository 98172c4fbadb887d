"""Segment-streamed MPS sampling with compute/I-O overlap (paper §3.1,
§3.3.2).

The in-memory walk needs the whole stacked Γ on the device: at χ = 10⁴ one
fp64 site is 3.2 GB and jiuzhang2's 144 sites are 460 GB.  This engine
splits the chain into site *segments* and, while the card walks segment k,
a pool thread has the store read segment k+1 (the store's own worker runs
a segment further ahead) and copy it to the card on the store's copy
stream, in the storage format, where it is upcast
(:meth:`~repro_torch.data.gamma_store.GammaStore.get_segment_on_device`).
At most two segments are on the device at a time, the one being walked and
the one being fetched.

Behind :meth:`StreamingEngine.sample`:

* ``inmem`` — the ``core/sampler`` walk, the samples of ``sampler.sample``
  for the same key (``micro_batch=None``) or of ``sampler.sample_batched``
  (``micro_batch=N₂``: chunk c walks on ``split(key, n_micro)[c]``);
* ``dp`` / ``tp_single`` / ``tp_double`` — ``core/parallel``'s segment
  runner over the engine's mesh; an unclamped TP walk fetches only its
  rank's tile of each Γ (the store cuts each site on the host before the
  copy, ``tile=``), a ``parallel.ChainTile``;
* a multi-process ``runtime`` (``api/runtime.py``: an emulated cluster's
  member or a ``torch.distributed`` rank): the paper's §3.1 broadcast
  plane — only the root reads each segment from the store and broadcasts
  it in storage format on the prefetch thread, so the broadcast of
  segment k+1 overlaps the walk of segment k; a root read fault crosses
  the wire as an error frame, and every process raises it in the same
  round.  Each process's engine walks the segment it received; the
  segment's device work runs under ``runtime.compute_lock()``;
* dynamic bond dimensions (§3.4.2): a bucketed ``chi_profile`` splits the
  walk into χ-stages, segments never cross a stage, the environment goes
  through ``dynamic_bond.fit_env`` at each boundary and each site reaches
  the card cut to its stage's χ;
* per-segment checkpoints (``checkpoint/sampler_state`` plus one sample
  block file per segment) and ``resume=True``: a killed walk resumes at
  its last segment boundary and emits the uninterrupted samples (§4.1).
  On a multi-process runtime every boundary is kept, and the processes
  resume from the newest boundary all of them hold
  (``runtime.allreduce_min``);
* ``pipeline=True`` (the service's multi-batch jobs): once the walk's last
  segment is fetched, the pool fetches (or broadcasts) the first segment
  again for the next macro batch, behind this batch's last compute;
* macro batches as idempotent :class:`WorkQueue` items (:meth:`run_queue`);
* a ``shard`` map (``repro_torch.shard.ShardMap``) on a multi-process
  runtime: the sharded plane (Adamski & Brown, PAPERS.md) — each process
  reads only the sites it owns (a ``ShardedGammaStore`` view refuses any
  other), walks its segments, and at each ownership boundary ships only
  the (N, χ) env, ``log_scale`` (and ``log_prob``) to the next owner; the
  owners' sample blocks meet in one all-gather, so every process returns
  the same batch.  A pre-walk round verifies each owner's slice and
  repairs a rotted site from a peer's healthy copy;
* conditional sampling (``clamp``, a ``workloads.clamp`` spec): each
  segment walks ``core/clamped.py`` (the dp walk for every parallel
  scheme) with the segment's clamp arrays, ``log_prob`` is a carry across
  segments and ``stats["log_prob"]`` the walk's per-sample value.  A
  clamped walk neither checkpoints nor resumes (the sampler state has no
  ``log_prob``): its macro batches are rerun instead.

A tail segment shorter than ``segment_len`` is walked as it is: the JAX
package pads it with identity sites so that one jit compilation serves
every segment and discards their draws, which leaves env, the rescale and
the key untouched — the port compiles nothing per shape, so it skips them
and gives the same samples.

``state`` is the last walk's final :class:`~repro_torch.core.sampler.
SamplerState` (env, key, log_scale) and ``stats`` describes that walk:
``segments``, ``max_live_segments``,
``io_wait_s`` (the walk waiting for a segment), ``fetch_s`` (the pool
thread's time in fetching segments: the read or the broadcast, the
checks, the copy to the device started), ``compute_s``,
``store_io_s`` and ``io_bytes`` (the store's read seconds and payload
bytes), ``h2d_s`` and ``h2d_bytes`` (the copies to the card, by CUDA
events on the copy stream), ``wall_s``, ``io_hidden_frac`` and the
runtime's counters over the walk (``broadcast_send_bytes``,
``broadcast_recv_bytes``, ``broadcast_segments``, ``broadcast_s``,
``p2p_send_bytes``, ``p2p_recv_bytes``, ``p2p_msgs``); ``repaired_sites``
and ``quarantined_sites`` (the store's); on a sharded walk
``owned_segments``, ``handoffs``, ``handoff_send_bytes``,
``handoff_recv_bytes``, ``gather_bytes``, ``handoff_copy_s`` (the env's
copies between the card and the host), ``handoff_send_s`` (in
``runtime.send``), ``handoff_wait_s`` (in ``runtime.recv``: the wire and
the predecessor's walk) and ``gather_s``.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.api.runtime import LocalRuntime
from repro_torch.checkpoint.sampler_state import (load_sampler_state,
                                                  newest_checkpoint_site,
                                                  save_sampler_state)
from repro_torch.core import collectives as C
from repro_torch.core import dynamic_bond as DB
from repro_torch.core import parallel as PP
from repro_torch.core import prng
from repro_torch.core import sampler as S
from repro_torch.core.mps import MPS
from repro_torch.core.precision import real_dtype_of
from repro_torch.data.gamma_store import payload_on_device
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.runtime.faults import CorruptSegment, Fault
from repro_torch.shard import walk as SW
from repro_torch.shard.shardmap import chain_segments
from repro_torch.shard.store import ShardedGammaStore
from repro_torch.workloads.clamp import (clamp_map, normalize_clamp,
                                         segment_clamp_arrays, validate_clamp)


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """How to walk the chain (``engine.planner.plan_stream`` makes one)."""
    segment_len: int                    # sites per device-resident segment
    scheme: str = "inmem"               # "inmem" | "dp" | "tp_single" | "tp_double"
    micro_batch: Optional[int] = None   # N₂; composes with every scheme
    checkpoint_every: int = 0           # segments between checkpoints; 0 = off


class StreamingEngine:
    """Walks a chain stored in a :class:`GammaStore` under any DP × TP
    placement, never holding more than two segments on the device."""

    def __init__(self, store, *, semantics: str = "linear",
                 config: S.SamplerConfig = S.SamplerConfig(),
                 plan: StreamPlan = StreamPlan(segment_len=64),
                 mesh=None, pconfig: Optional[PP.ParallelConfig] = None,
                 checkpoint_dir: Optional[str] = None,
                 chi_profile=None, runtime=None, shard=None, clamp=None,
                 device: DeviceLike = None):
        self.clamp = normalize_clamp(clamp)   # None: the unclamped walk
        self.runtime = runtime or LocalRuntime()
        self.store = store
        self._source_store = store
        self._wrapped_store = None
        self.n_sites = store.n_sites
        if self.n_sites == 0:
            raise ValueError(f"empty GammaStore at {store.root}")
        self.shard = shard
        if shard is not None:
            if shard.n_sites != self.n_sites:
                raise ValueError(f"shard map covers {shard.n_sites} sites, "
                                 f"store holds {self.n_sites}")
            if shard.n_hosts != self.runtime.process_count:
                raise ValueError(
                    f"shard map spans {shard.n_hosts} hosts but the runtime "
                    f"has {self.runtime.process_count} processes")
            if shard.n_hosts > 1 and not isinstance(store, ShardedGammaStore):
                # a shared root: this host's ownership-enforcing view,
                # owned by the engine (the caller's store stays as it is)
                self.store = ShardedGammaStore(
                    store.root, shard, self.runtime.process_index,
                    storage_dtype=store.storage_dtype,
                    compute_dtype=store.compute_dtype, verify=True)
                self._wrapped_store = self.store
        # bytes that cross processes are verified: a flipped bit must
        # surface as a CorruptSegment before any sample is drawn
        if self.runtime.process_count > 1:
            self.store.verify = True
        self.device = (mesh.device if mesh is not None and device is None
                       else resolve_device(device))
        # pinned reads make the copies to the card asynchronous
        self.store.pin_memory = self.device.type == "cuda"
        shape = self.store.meta(0)        # the npz header, no Γ payload
        self.chi, self.d = shape[0], shape[2]
        self.gamma_dtype = store.compute_dtype
        self.semantics = semantics
        self.config = config
        self.plan = plan
        if plan.scheme != "inmem" and mesh is None:
            raise ValueError(f"scheme {plan.scheme!r} needs a mesh")
        self.mesh = mesh
        self.pconfig = pconfig or PP.ParallelConfig(scheme=plan.scheme)
        if plan.scheme != "inmem" and plan.micro_batch is not None:
            self.pconfig = dataclasses.replace(self.pconfig,
                                               micro_batch=plan.micro_batch)
        self.chi_profile = (None if chi_profile is None
                            else np.asarray(chi_profile, dtype=np.int64))
        if self.chi_profile is not None:
            if len(self.chi_profile) != self.n_sites:
                raise ValueError(f"chi_profile covers "
                                 f"{len(self.chi_profile)} of "
                                 f"{self.n_sites} sites")
            if int(self.chi_profile.max()) > self.chi:
                raise ValueError("chi_profile exceeds the stored χ "
                                 f"({int(self.chi_profile.max())} > "
                                 f"{self.chi})")
        self.checkpoint_dir = checkpoint_dir
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._live_lock = threading.Lock()
        self._live = 0
        self._walk_lock = threading.Lock()
        # the next walk's first segment, fetched behind this walk's last
        # compute: ((start, stop, χ), Future)
        self._warm: Optional[tuple] = None
        self.stats: dict = {}
        self.state: Optional[S.SamplerState] = None
        self._begin_walk()
        # every segment of the real schedule (χ-stages included) needs one
        # owner: checked once, here
        self._seg_owners = (None if shard is None else
                            tuple(shard.segment_owner(s0, s1)
                                  for s0, s1, _ in self._segment_schedule()))

    # -- chain schedule ------------------------------------------------------
    def _segment_schedule(self) -> list[tuple[int, int, int]]:
        """[(start, stop, χ_stage)]: ``plan.segment_len`` chunks that never
        cross a χ-stage."""
        if self.chi_profile is None:
            stages = [(0, self.n_sites, self.chi)]
        else:
            stages = [(st.start, st.stop, st.chi)
                      for st in DB.stages_from_profile(self.chi_profile)]
        for s0, s1, _ in stages:
            if self.pconfig.scheme == "tp_double" and (s0 % 2 or s1 % 2):
                raise ValueError(
                    "tp_double pairs sites (2j, 2j+1): χ-stage boundaries "
                    f"must be even (got stage [{s0}, {s1}))")
        return chain_segments(self.n_sites, self.plan.segment_len, stages)

    # -- segment fetch (on the pool thread) ---------------------------------
    def _fetch_via_runtime(self, start: int, stop: int, chi_s: int) -> dict:
        """Paper §3.1: the root reads the segment once and broadcasts it.

        Only the root touches the store; the wire carries the storage
        format (bf16 Γ stays two bytes), and every process, the root
        included, checks the payload's checksum and moves it to its device
        through ``gamma_store.payload_on_device``, so the walk equals a
        single-process one bit for bit.  A root read fault crosses the wire
        as an error frame: every process raises the same structured fault
        in the same round instead of waiting in the collective."""
        payload = None
        if self.runtime.is_root:
            try:
                payload = self.store.get_segment_raw(start, stop - start)
            except CorruptSegment as e:
                payload = {"start": start, "error": str(e),
                           "fault": e.fault.to_dict()}
        payload = self.runtime.broadcast_segment(payload)
        if payload.get("error") is not None:
            fd = dict(payload.get("fault") or {})
            raise CorruptSegment(Fault(
                kind=fd.get("kind", "corruption"),
                message=fd.get("message", str(payload["error"])),
                site=fd.get("site"), store=fd.get("store")))
        if int(payload["start"]) != start:
            raise RuntimeError(
                f"broadcast schedule desync: this process expected segment "
                f"start {start} but received {payload['start']} — are all "
                f"processes walking the same plan?")
        return payload_on_device(
            payload, self.device, chi=chi_s if chi_s < self.chi else None,
            compute_dtype=self.gamma_dtype,
            stream=(self.store.copy_stream(self.device)
                    if self.device.type == "cuda" else None),
            tile=self._tile_spec())

    def _tile_spec(self) -> Optional[tuple]:
        """(scheme, p₂, rank) when this walk takes only its rank's tile of
        each Γ (an unclamped tp_single or tp_double walk; the clamped
        walk runs dp on the whole Γ); None otherwise."""
        scheme = self.pconfig.scheme
        if self.clamp is not None or scheme not in ("tp_single",
                                                    "tp_double"):
            return None
        model = self.mesh.group(self.pconfig.model_axis)
        return scheme, C.axis_size(model), C.axis_index(model)

    def _fetch(self, start: int, stop: int, chi_s: int) -> dict:
        t0 = time.perf_counter()
        sharded = self.shard is not None and self.runtime.process_count > 1
        if self.runtime.process_count > 1 and not sharded:
            seg = self._fetch_via_runtime(start, stop, chi_s)
        else:
            # a sharded walk reads its own slice here, and schedules its
            # next owned segment itself: no blanket next-segment prefetch
            seg = self.store.get_segment_on_device(
                start, stop - start, self.device,
                chi=chi_s if chi_s < self.chi else None,
                prefetch_next_segment=not sharded, tile=self._tile_spec())
        self.stats["fetch_s"] += time.perf_counter() - t0
        with self._live_lock:
            self._live += 1
            self.stats["max_live_segments"] = max(
                self.stats["max_live_segments"], self._live)
        return seg

    def _take(self, seg: dict):
        """Hand a fetched segment to the walk's stream: wait for its copy
        and tell the allocator the walk's stream uses its memory.  Returns
        the segment's :class:`MPS`, or this rank's ``ChainTile`` of it."""
        if seg["ready"] is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(seg["ready"])
            seg["gammas"].record_stream(cur)
            seg["lambdas"].record_stream(cur)
        tile = self._tile_spec()
        if tile is None:
            return MPS(seg["gammas"], seg["lambdas"], self.semantics)
        return PP.ChainTile(seg["gammas"], seg["lambdas"], self.semantics,
                            *tile, gammas_right=seg["gammas_right"])

    def _release(self, seg: dict) -> None:
        if seg["copy"] is not None:      # the walk waited on the copy
            h2d0, h2d1 = seg["copy"]
            self.stats["h2d_s"] += h2d0.elapsed_time(h2d1) / 1e3
        self.stats["h2d_bytes"] += seg["bytes"]
        seg.clear()
        with self._live_lock:
            self._live -= 1

    def _drop(self, seg: dict) -> None:
        """Release a segment the walk will not use, once its copy is done."""
        if seg["ready"] is not None:
            seg["ready"].synchronize()
        self._release(seg)

    def _take_warm(self, seg_key) -> Optional[Future]:
        """Claim the gang-scheduled first-segment fetch if it is this
        walk's first segment; release a stale one (a failed speculative
        fetch does not fail a walk that never needed it)."""
        if self._warm is None:
            return None
        key, fut = self._warm
        self._warm = None
        if key == seg_key:
            return fut
        try:
            self._drop(fut.result())
        except Exception:
            pass
        return None

    def _drop_pending(self, fut: Optional[Future], seg: Optional[dict]
                      ) -> None:
        """After a walk that raised: wait for the prefetch in flight and
        release it and the segment the walk held (a failed fetch holds
        nothing)."""
        if seg:
            self._drop(seg)
        if fut is not None:
            try:
                pending = fut.result()
            except Exception:
                return
            self._drop(pending)

    # -- one segment of the data plane --------------------------------------
    def _run_segment(self, seg, env, log_scale, key, start: int):
        if self.plan.scheme != "inmem":
            return PP.sample_segment(self.mesh, seg, env, key, start,
                                     self.pconfig, self.config,
                                     log_scale=log_scale)

        def chain(k, e, ls):
            res = S.sample_chain(seg, S.SamplerState(e, k, ls), self.config,
                                 start_site=start)
            return res.samples, res.state.env, res.state.log_scale
        # chunk c of N₂ on split(key, n_micro)[c]: sample_batched's schedule
        return PP._with_micro(chain, key, env, log_scale,
                              self.plan.micro_batch)

    def _run_segment_clamped(self, seg: MPS, env, log_scale, log_prob, key,
                             start: int):
        """The clamped twin of ``_run_segment``: the segment's (mask, vals)
        from the clamp spec, the dp walk for every parallel scheme.
        Returns ``(samples, env', log_scale', log_prob')``."""
        from repro_torch.core import clamped as CL

        mask, vals = segment_clamp_arrays(clamp_map(self.clamp), start,
                                          seg.n_sites, env.shape[0])
        if self.plan.scheme == "inmem":
            return CL.clamped_segment(
                seg.gammas, seg.lambdas, env, key, start, mask, vals,
                self.config, log_scale=log_scale, log_prob=log_prob,
                micro_batch=self.plan.micro_batch)
        return CL.sample_segment_clamped(
            self.mesh, seg, env, key, start, mask, vals,
            CL.dp_equivalent_pconfig(self.pconfig), self.config,
            log_scale=log_scale, log_prob=log_prob)

    def _load_sample_blocks(self, up_to_site: int,
                            ckpt_dir: str) -> list[np.ndarray]:
        """The per-segment sample blocks covering [0, up_to_site)."""
        blocks, cursor = [], 0
        names = sorted(f for f in os.listdir(ckpt_dir)
                       if f.startswith("samples_") and f.endswith(".npy"))
        for fn in names:
            offset = int(fn[len("samples_"):-len(".npy")])
            if offset >= up_to_site:
                break
            if offset != cursor:
                raise ValueError(f"sample blocks in {ckpt_dir} leave a gap "
                                 f"at site {cursor}")
            blk = np.load(os.path.join(ckpt_dir, fn))
            blocks.append(blk)
            cursor += blk.shape[0]
        if cursor != up_to_site:
            raise ValueError(f"sample blocks in {ckpt_dir} cover {cursor} "
                             f"of the checkpoint's {up_to_site} sites")
        return blocks

    # -- per-walk bookkeeping ------------------------------------------------
    def _begin_walk(self) -> None:
        """Zero the per-walk stats and anchor the store's and the
        runtime's counters."""
        self._store_io0 = (self.store.io_seconds, self.store.io_bytes)
        self._store_q0 = (self.store.quarantined_sites,
                          self.store.repaired_sites)
        self._runtime_io0 = dict(self.runtime.io_counters())
        with self._live_lock:
            live = self._live           # a warm prefetched segment counts
        self.stats.update(segments=0, io_wait_s=0.0, compute_s=0.0,
                          max_live_segments=live, store_io_s=0.0,
                          io_bytes=0, io_hidden_frac=0.0, h2d_s=0.0,
                          h2d_bytes=0, fetch_s=0.0, wall_s=0.0,
                          quarantined_sites=0, repaired_sites=0,
                          owned_segments=0, handoffs=0,
                          handoff_send_bytes=0, handoff_recv_bytes=0,
                          gather_bytes=0, handoff_copy_s=0.0,
                          handoff_send_s=0.0, handoff_wait_s=0.0,
                          gather_s=0.0)
        for k, v in self._runtime_io0.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.stats[k] = 0
        self.stats.pop("log_prob", None)    # a clamped walk sets it

    def _finish_walk(self, t_walk: float) -> None:
        self.stats["wall_s"] = time.perf_counter() - t_walk
        self.stats["store_io_s"] = self.store.io_seconds - self._store_io0[0]
        self.stats["io_bytes"] = self.store.io_bytes - self._store_io0[1]
        self.stats["quarantined_sites"] = (self.store.quarantined_sites
                                           - self._store_q0[0])
        self.stats["repaired_sites"] = (self.store.repaired_sites
                                        - self._store_q0[1])
        if self.stats["store_io_s"] > 0:
            hidden = max(0.0,
                         self.stats["store_io_s"] - self.stats["io_wait_s"])
            self.stats["io_hidden_frac"] = hidden / self.stats["store_io_s"]
        counters = self.runtime.io_counters()
        for k, v0 in self._runtime_io0.items():
            if k in self.stats:
                self.stats[k] = counters[k] - v0
        # every process finishes macro batch b before any starts b+1
        self.runtime.barrier()

    # -- the walk ------------------------------------------------------------
    _UNSET = object()

    def sample(self, n_samples: int, key: torch.Tensor, *,
               resume: bool = False,
               stop_after_segments: Optional[int] = None,
               checkpoint_dir=_UNSET, pipeline: bool = False) -> np.ndarray:
        """Walk the whole chain; returns (N, M) int64 outcomes.

        ``resume=True`` continues from the newest checkpoint (the
        uninterrupted run's samples); ``checkpoint_dir`` overrides the
        engine's for this walk; ``stop_after_segments`` stops the walk
        there as a kill would, after checkpointing the boundary, and
        returns the (N, sites_done) block walked so far; ``pipeline=True``
        fetches the first segment again behind the last one, for the next
        macro batch."""
        return self.sample_with_stats(
            n_samples, key, resume=resume,
            stop_after_segments=stop_after_segments,
            checkpoint_dir=checkpoint_dir, pipeline=pipeline)[0]

    def sample_with_stats(self, n_samples: int, key: torch.Tensor, *,
                          resume: bool = False,
                          stop_after_segments: Optional[int] = None,
                          checkpoint_dir=_UNSET, pipeline: bool = False
                          ) -> tuple[np.ndarray, dict]:
        """:meth:`sample` and a copy of its stats, taken under the walk
        lock (a session shares one engine across its macro batches)."""
        with self._walk_lock:
            out = self._sample_locked(n_samples, key, resume=resume,
                                      stop_after_segments=stop_after_segments,
                                      checkpoint_dir=checkpoint_dir,
                                      pipeline=pipeline)
            return out, dict(self.stats)

    def _sample_locked(self, n_samples: int, key: torch.Tensor, *,
                       resume: bool, stop_after_segments: Optional[int],
                       checkpoint_dir, pipeline: bool) -> np.ndarray:
        ckpt_dir = (self.checkpoint_dir if checkpoint_dir is self._UNSET
                    else checkpoint_dir)
        if self.clamp is not None:
            if resume or ckpt_dir:
                raise ValueError(
                    "clamped walks do not checkpoint or resume (the sampler "
                    "state has no log_prob slot) — drop checkpoint_dir/"
                    "resume and rely on idempotent macro batches")
            validate_clamp(self.clamp, n_sites=self.n_sites, d=self.d,
                           n_samples=n_samples)
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
        if self.shard is not None and self.runtime.process_count > 1:
            return self._sample_sharded(
                n_samples, key, resume=resume,
                stop_after_segments=stop_after_segments, ckpt_dir=ckpt_dir,
                pipeline=pipeline)
        self._begin_walk()
        t_walk = time.perf_counter()
        if self.plan.micro_batch is not None and \
                n_samples % self.plan.micro_batch:
            raise ValueError(f"micro_batch={self.plan.micro_batch} must "
                             f"divide n_samples={n_samples}")
        multi = self.runtime.process_count > 1
        if multi and stop_after_segments is not None:
            raise ValueError(
                "stop_after_segments injects a single-process kill — on a "
                "multi-process runtime the peers would block on the "
                "broadcast")

        schedule = self._segment_schedule()
        boundaries = {s for s, _, _ in schedule} | {self.n_sites}
        idx = 0
        done: list[np.ndarray] = []       # site-major (L_i, N) blocks
        persisted = 0                     # blocks already on disk
        env = PP.segment_env_init(n_samples, schedule[0][2], self.gamma_dtype,
                                  self.device)
        log_scale = torch.zeros((n_samples,), dtype=real_dtype_of(env.dtype),
                                device=self.device)
        log_prob = (None if self.clamp is None else
                    torch.zeros_like(log_scale))
        if resume:
            if not ckpt_dir:
                raise ValueError("resume=True needs a checkpoint_dir")
            if multi:
                # the processes' newest boundaries may differ after an
                # unclean stop: resume from the newest one they all hold
                # (every boundary is kept, keep=0); 0 starts afresh
                agreed = self.runtime.allreduce_min(
                    newest_checkpoint_site(ckpt_dir))
                loaded = (load_sampler_state(ckpt_dir, site=agreed,
                                             device=self.device)
                          if agreed > 0 else None)
            else:
                loaded = load_sampler_state(ckpt_dir, device=self.device)
        if resume and loaded is not None:
            site, state, _ = loaded
            if site not in boundaries:
                raise ValueError(f"checkpoint at site {site} is not a "
                                 f"segment boundary of this plan "
                                 f"({sorted(boundaries)})")
            # a mismatched key would splice two runs into one batch
            if not torch.equal(key.cpu(), state.key):
                raise ValueError("resume key does not match the "
                                 "checkpointed run")
            env, key, log_scale = state.env, state.key, state.log_scale
            idx = next((i for i, (s, _, _) in enumerate(schedule)
                        if s == site), len(schedule))
            done = self._load_sample_blocks(site, ckpt_dir)
            persisted = len(done)

        fut: Optional[Future] = None      # the segment being fetched
        seg: Optional[dict] = None        # the segment the walk holds
        try:
            if idx < len(schedule):
                fut = self._take_warm(schedule[idx])
                if fut is None:
                    fut = self._pool.submit(self._fetch, *schedule[idx])
            seg_idx = 0
            while idx < len(schedule):
                start, stop, chi_s = schedule[idx]
                t0 = time.perf_counter()
                seg, fut = fut.result(), None
                self.stats["io_wait_s"] += time.perf_counter() - t0
                if idx + 1 < len(schedule):   # double buffer: fetch k+1 now
                    fut = self._pool.submit(self._fetch, *schedule[idx + 1])
                elif pipeline and stop_after_segments is None:
                    # the pool is idle for the rest of this walk: fetch (or
                    # broadcast) the next macro batch's first segment now
                    self._warm = (schedule[0], self._pool.submit(
                        self._fetch, *schedule[0]))

                t0 = time.perf_counter()
                with self.runtime.compute_lock():
                    part = self._take(seg)
                    env = DB.fit_env(env, chi_s)   # χ-stage transition
                    if self.clamp is None:
                        samples, env, log_scale = self._run_segment(
                            part, env, log_scale, key, start)
                    else:
                        samples, env, log_scale, log_prob = \
                            self._run_segment_clamped(part, env, log_scale,
                                                      log_prob, key, start)
                    del part
                    samples = samples.cpu().numpy().astype(np.int32)
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
                self.stats["compute_s"] += time.perf_counter() - t0
                self._release(seg)
                seg = None
                done.append(samples)
                self.stats["segments"] += 1
                idx += 1
                seg_idx += 1

                stopping = (stop_after_segments is not None
                            and seg_idx >= stop_after_segments
                            and idx < len(schedule))
                ckpt_due = (self.plan.checkpoint_every
                            and seg_idx % self.plan.checkpoint_every == 0)
                if ckpt_dir and (ckpt_due or stopping):
                    # one block file per segment, written once
                    cursor = stop - sum(b.shape[0] for b in done[persisted:])
                    for blk in done[persisted:]:
                        np.save(os.path.join(ckpt_dir,
                                             f"samples_{cursor:06d}.npy"),
                                blk)
                        cursor += blk.shape[0]
                    persisted = len(done)
                    # a multi-process walk keeps every boundary: the resume
                    # agreement may pick one a slower process is still at
                    save_sampler_state(
                        ckpt_dir, stop, S.SamplerState(env, key, log_scale),
                        np.zeros((0, n_samples), dtype=np.int32),
                        keep=0 if multi else 3)
                if stopping:              # the prefetch we no longer need
                    pending, fut = fut.result(), None
                    self._drop(pending)
                    break
        except BaseException:
            self._drop_pending(fut, seg)
            raise

        self.state = S.SamplerState(env, key, log_scale)
        if log_prob is not None:
            self.stats["log_prob"] = log_prob.cpu().numpy()
        self._finish_walk(t_walk)
        if not done:
            return np.zeros((n_samples, 0), dtype=np.int64)
        return np.concatenate(done, axis=0).T.astype(np.int64)

    # -- the sharded plane --------------------------------------------------
    def _verify_and_repair_sharded(self, me: int) -> None:
        """The pre-walk repair round: every host verifies its owned slice
        against the digest manifest, the union of corrupt sites is
        all-gathered, and each corrupt site is written again from the
        lowest-ranked peer that holds a healthy copy, over tagged
        ``send``/``recv``.  With no healthy holder, every process raises
        the same ``kind="corruption"`` :class:`CorruptSegment` in the same
        round, so no collective is left waiting."""
        if not self.store.verify:
            return
        mine = self.store.verify_sites()
        rounds = self.runtime.allgather_payloads(
            {"corrupt": np.asarray(sorted(mine), dtype=np.int64)})
        bad = sorted({int(s) for pay in rounds
                      for s in np.asarray(pay["corrupt"]).ravel()})
        for site in bad:
            owner = self.shard.owner(site)
            healthy = int(me != owner and self.store.has_healthy_copy(site))
            votes = self.runtime.allgather_payloads(
                {"healthy": np.asarray([healthy], dtype=np.int64)})
            helpers = [r for r, pay in enumerate(votes)
                       if int(np.asarray(pay["healthy"]).ravel()[0])]
            if not helpers:
                raise CorruptSegment(Fault(
                    kind="corruption", site=site, store=self.store.root,
                    message=f"Γ site {site} (owner host {owner}) is corrupt "
                            f"and no peer holds a healthy copy — "
                            f"unrepairable; failing the job cleanly"))
            helper, tag = helpers[0], ("repair", site)
            if me == helper:
                data = self.store.read_repair_bytes(site)
                self.runtime.send(owner, {
                    "site": np.asarray(site, dtype=np.int64),
                    "data": np.frombuffer(data, dtype=np.uint8)}, tag=tag)
            elif me == owner:
                pay = self.runtime.recv(helper, tag=tag)
                if int(np.asarray(pay["site"])) != site:
                    raise RuntimeError(
                        f"repair desync: host {me} expected bytes for site "
                        f"{site} but received site "
                        f"{int(np.asarray(pay['site']))}")
                self.store.restore_site(
                    site, np.asarray(pay["data"], dtype=np.uint8).tobytes())
            else:
                self.runtime.observe_handoff(helper, tag=tag)

    def _sample_sharded(self, n_samples: int, key: torch.Tensor, *,
                        resume: bool, stop_after_segments: Optional[int],
                        ckpt_dir, pipeline: bool) -> np.ndarray:
        """The block-cyclic sharded walk.

        Every process goes through the same segment schedule, and segment
        k is walked only by its owner; at each ownership boundary the
        (N, χ) env (never Γ) crosses to the next owner, whose fetch of its
        own first segment ran behind its predecessor's walk.  A barrier
        and one sample-block all-gather end the walk, so every process
        returns the same (N, M) batch.

        Crash consistency: an owner saves a received boundary before it
        walks from it, and each walked block and the boundary after it
        right after the walk, all with ``keep=0``; so the boundary the
        processes agree on (``allreduce_min``) is on disk where the resume
        needs it, with every owned block below it."""
        if stop_after_segments is not None:
            raise ValueError(
                "stop_after_segments injects a single-process kill — on a "
                "sharded runtime the peers would block on the env handoff")
        self._begin_walk()
        t_walk = time.perf_counter()
        if self.plan.micro_batch is not None and \
                n_samples % self.plan.micro_batch:
            raise ValueError(f"micro_batch={self.plan.micro_batch} must "
                             f"divide n_samples={n_samples}")
        schedule = self._segment_schedule()
        owners = list(self._seg_owners)
        me = self.runtime.process_index
        self._verify_and_repair_sharded(me)
        base_key = key.cpu().numpy().astype(np.uint32)

        idx0 = 0
        blocks: dict[int, np.ndarray] = {}     # start site → (L, N) block
        env = PP.segment_env_init(n_samples, schedule[0][2], self.gamma_dtype,
                                  self.device)
        log_scale = torch.zeros((n_samples,), dtype=real_dtype_of(env.dtype),
                                device=self.device)
        log_prob = (None if self.clamp is None else
                    torch.zeros_like(log_scale))
        if resume:
            if not ckpt_dir:
                raise ValueError("resume=True needs a checkpoint_dir")
            agreed = self.runtime.allreduce_min(
                newest_checkpoint_site(ckpt_dir))
            if agreed > 0:
                boundaries = {s for s, _, _ in schedule} | {self.n_sites}
                if agreed not in boundaries:
                    raise ValueError(f"checkpoint at site {agreed} is not a "
                                     f"segment boundary of this plan "
                                     f"({sorted(boundaries)})")
                idx0 = next((i for i, (s, _, _) in enumerate(schedule)
                             if s == agreed), len(schedule))
                for i in range(idx0):          # my blocks below the boundary
                    if owners[i] == me:
                        s0 = schedule[i][0]
                        blocks[s0] = np.load(os.path.join(
                            ckpt_dir, f"samples_{s0:06d}.npy"))
                if idx0 < len(schedule) and owners[idx0] == me:
                    _, state, _ = load_sampler_state(ckpt_dir, site=agreed,
                                                     device=self.device)
                    if not torch.equal(key.cpu(), state.key):
                        raise ValueError("resume key does not match the "
                                         "checkpointed run")
                    env, log_scale = state.env, state.log_scale

        owned = [i for i in range(idx0, len(schedule)) if owners[i] == me]
        self.stats["owned_segments"] = len(owned)
        fut: Optional[Future] = None      # the segment being fetched
        seg: Optional[dict] = None        # the segment the walk holds
        try:
            if owned:
                fut = self._take_warm(schedule[owned[0]])
                if fut is None:
                    fut = self._pool.submit(self._fetch, *schedule[owned[0]])
            next_pos = 1                  # the next entry of `owned` to fetch
            for idx in range(idx0, len(schedule)):
                start, stop, chi_s = schedule[idx]
                prev = owners[idx - 1] if idx > idx0 else None
                incoming = prev is not None and prev != owners[idx]
                if owners[idx] != me:
                    if incoming and prev != me:
                        self.runtime.observe_handoff(prev, tag=start)
                    continue
                if incoming:              # I take over: receive the env
                    t0 = time.perf_counter()
                    payload = self.runtime.recv(prev, tag=start)
                    self.stats["handoff_wait_s"] += time.perf_counter() - t0
                    env_h, ls_h, key_h, site = SW.decode_handoff(payload)
                    if site != start:
                        raise RuntimeError(
                            f"handoff desync: host {me} expected the env at "
                            f"site {start} but received site {site} — are "
                            f"all processes walking the same plan?")
                    if not np.array_equal(key_h, base_key):
                        raise RuntimeError(
                            "handoff key does not match this walk's base "
                            "key — the predecessor owner is sampling a "
                            "different (n_samples, key) job")
                    t0 = time.perf_counter()
                    env = torch.from_numpy(env_h).to(self.device)
                    log_scale = torch.from_numpy(ls_h).to(self.device)
                    if self.clamp is not None:
                        lp_h = SW.decode_handoff_log_prob(payload)
                        if lp_h is None:
                            raise RuntimeError(
                                "clamped walk received a handoff without the "
                                "log_prob carry — is the predecessor owner "
                                "running an unclamped plan?")
                        log_prob = torch.from_numpy(lp_h).to(self.device)
                    self.stats["handoff_copy_s"] += time.perf_counter() - t0
                    self.stats["handoffs"] += 1
                    self.stats["handoff_recv_bytes"] += \
                        SW.payload_nbytes(payload)
                    if ckpt_dir:          # on disk before the walk uses it
                        save_sampler_state(
                            ckpt_dir, start,
                            S.SamplerState(env, key, log_scale),
                            np.zeros((0, n_samples), dtype=np.int32), keep=0)

                t0 = time.perf_counter()
                seg, fut = fut.result(), None
                self.stats["io_wait_s"] += time.perf_counter() - t0
                if next_pos < len(owned):   # fetch my next owned segment
                    fut = self._pool.submit(self._fetch,
                                            *schedule[owned[next_pos]])
                    next_pos += 1
                elif pipeline:            # the next walk's first segment
                    self._warm = (schedule[owned[0]], self._pool.submit(
                        self._fetch, *schedule[owned[0]]))

                t0 = time.perf_counter()
                with self.runtime.compute_lock():
                    part = self._take(seg)
                    env = DB.fit_env(env, chi_s)
                    if self.clamp is None:
                        samples, env, log_scale = self._run_segment(
                            part, env, log_scale, key, start)
                    else:
                        samples, env, log_scale, log_prob = \
                            self._run_segment_clamped(part, env, log_scale,
                                                      log_prob, key, start)
                    del part
                    samples = samples.cpu().numpy().astype(np.int32)
                    if self.device.type == "cuda":
                        torch.cuda.current_stream(self.device).synchronize()
                self.stats["compute_s"] += time.perf_counter() - t0
                self._release(seg)
                seg = None
                blocks[start] = samples
                self.stats["segments"] += 1
                if ckpt_dir:
                    np.save(os.path.join(ckpt_dir,
                                         f"samples_{start:06d}.npy"), samples)
                    save_sampler_state(
                        ckpt_dir, stop, S.SamplerState(env, key, log_scale),
                        np.zeros((0, n_samples), dtype=np.int32), keep=0)
                if idx + 1 < len(schedule) and owners[idx + 1] != me:
                    t0 = time.perf_counter()
                    payload = SW.encode_handoff(env, log_scale, key, stop,
                                                log_prob=log_prob)
                    t1 = time.perf_counter()
                    self.runtime.send(owners[idx + 1], payload, tag=stop)
                    self.stats["handoff_copy_s"] += t1 - t0
                    self.stats["handoff_send_s"] += time.perf_counter() - t1
                    self.stats["handoffs"] += 1
                    self.stats["handoff_send_bytes"] += \
                        SW.payload_nbytes(payload)
        except BaseException:
            self._drop_pending(fut, seg)
            raise

        # every process finishes its slice before the sample gather
        t0 = time.perf_counter()
        self.runtime.barrier()
        merged: dict[int, np.ndarray] = {}
        for pay in self.runtime.allgather_payloads(SW.encode_blocks(blocks)):
            self.stats["gather_bytes"] += SW.payload_nbytes(pay)
            merged.update(SW.decode_blocks(pay))
        out = SW.assemble_blocks(merged, self.n_sites, n_samples)
        if self.clamp is not None:
            # the finished carry lives with the last segment's owner: one
            # more small gather gives every process the same log_prob
            mine = (log_prob.cpu().numpy() if owners[-1] == me
                    else np.zeros((0,), dtype=np.float64))
            for pay in self.runtime.allgather_payloads({"log_prob": mine}):
                arr = np.asarray(pay["log_prob"])
                if arr.size:
                    self.stats["log_prob"] = arr
        self.stats["gather_s"] = time.perf_counter() - t0
        self.state = S.SamplerState(env, key, log_scale)
        self._finish_walk(t_walk)
        return out

    def run_queue(self, queue, per_batch: int, base_key: torch.Tensor,
                  worker: str = "engine") -> dict[int, np.ndarray]:
        """Macro batches (paper N₁) as work items: batch b walks on
        ``fold_in(base_key, b)``, so a restarted queue recomputes only the
        batches it has not completed, with the same results."""
        out: dict[int, np.ndarray] = {}
        while (b := queue.claim(worker)) is not None:
            out[b] = self.sample(per_batch, prng.fold_in(base_key, b))
            queue.complete(b)
        return out

    def close(self, close_store: bool = True) -> None:
        """Release a gang-scheduled segment still in its slot and join the
        pool thread; ``close_store=False`` leaves a (shared) store open."""
        if self._warm is not None:
            _, fut = self._warm
            self._warm = None
            try:
                self._drop(fut.result())
            except Exception:           # the fetch failed: nothing is live
                pass
        self._pool.shutdown(wait=True)
        if self._wrapped_store is not None:
            # the engine's own view (and its reader thread)
            self._wrapped_store.close()
        if close_store:
            self._source_store.close()

    def __enter__(self) -> "StreamingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

