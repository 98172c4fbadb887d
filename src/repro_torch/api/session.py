"""`SamplingSession` — the port's front door for chain sampling.

The session owns the source — an in-memory :class:`MPS` (kept where its
caller put it: a seq or dp walk moves it to the session's device once, a
tensor-parallel walk copies only its rank's tiles there), a
:class:`~repro_torch.data.gamma_store.GammaStore`, or
a store's path — resolves a :class:`SamplerConfig` against it, and routes
``sample(n, key)`` to the registered data plane::

    from repro_torch import api
    from repro_torch.core import prng

    with api.SamplingSession(mps) as session:          # on the CUDA card
        samples = session.sample(4096, prng.key(0))    # (N, M) outcomes

    cfg = api.SamplerConfig(backend="streamed", checkpoint_dir=ckpt)
    with api.SamplingSession(store, cfg) as session:   # Γ streamed
        samples = session.sample(4096, key)
        resumed = session.sample(4096, key, resume=True)

A store source walks ``streamed`` by default (``backend="inmem"`` loads the
whole chain instead); an MPS source with ``backend="streamed"`` is written
once to a store of its own dtype in ``store_root`` (a temporary directory,
removed on ``close``, by default).  ``device`` defaults to the card;
without a GPU the session raises unless ``device="cpu"`` is passed.
``mesh`` (``launch.mesh.make_mesh``) places the walk over DP × TP ranks:
every rank of the job builds the same session and calls ``sample`` with the
same key, and every rank gets the full (N, M) array back, as the JAX
package's controller does; the session then runs on the mesh's device.
``sample`` is a one-batch job on the session's private one-lane
:class:`~repro_torch.api.service.SamplingService`, drawn on its key
unchanged; ``run_queue`` runs macro batch b as ``sample(per_batch,
fold_in(base, b))``; :meth:`_execute_batch` is the one place a data plane
is called.  ``stats`` holds the last walk's statistics (the streamed
engine's, the runtime's counters for ``backend="remote"``) and, after a
clamped call (``SamplerConfig(clamp=...)``), the per-sample ``log_prob``
of the clamped branch.  ``config.runtime`` places the session: ``local``,
``multihost`` (one session per rank, the root reads and broadcasts each
segment), ``remote`` (the ``remote`` data plane dispatches to a worker)
or a runtime instance (an ``emulated_cluster`` member).
"""
from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
import threading
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.api.backends import SampleRequest, get_backend
from repro_torch.api.config import SamplerConfig, SessionPlan, resolve_plan
from repro_torch.api.runtime import ClusterRuntime, resolve_runtime
from repro_torch.core.mps import MPS
from repro_torch.data.gamma_store import GammaStore
from repro_torch.device import DeviceLike, resolve_device


class SamplingSession:
    """Facade over the data-plane registry; see module docstring."""

    def __init__(self, source: Union[MPS, GammaStore, str, os.PathLike],
                 config: Optional[SamplerConfig] = None, *,
                 device: DeviceLike = None, mesh=None):
        self.config = config or SamplerConfig()
        self.mesh = mesh
        self.device = (resolve_device(device) if device is not None
                       or mesh is None else mesh.device)
        self._mps: Optional[MPS] = None     # where the caller put it
        self._dev_mps: Optional[MPS] = None  # the whole chain on the device
        self._tiles: dict = {}               # this rank's TP tiles by stage
        self._store: Optional[GammaStore] = None
        self._owns_store = False
        self._tmp_store_root: Optional[str] = None
        self._plans: dict[int, SessionPlan] = {}
        self._engines: dict = {}
        self._lock = threading.RLock()
        self._closed = False
        self._service = None            # the one-lane service behind sample
        # a process group's collectives are issued in one order: walks over
        # the mesh take turns when several lanes share the session
        self._mesh_lock = threading.Lock()
        self.stats: dict = {}
        # the runtime is session state (it may hold worker processes); a
        # runtime resolved from a name is the session's to close
        self.runtime = resolve_runtime(self.config.runtime)
        self._owns_runtime = not isinstance(self.config.runtime,
                                            ClusterRuntime)
        if isinstance(source, (str, os.PathLike)):
            source = GammaStore(str(source))
            self._owns_store = True
        if isinstance(source, GammaStore):
            if source.n_sites == 0:
                raise ValueError(f"empty GammaStore at {source.root}")
            self._store = source
            shape = source.meta(0)          # the header, no Γ payload
            self.n_sites, self.chi, self.d = (source.n_sites, shape[0],
                                              shape[2])
            self._semantics, self._hint = None, "streamed"
            self._elt_bytes = torch.empty(
                (), dtype=source.compute_dtype).element_size()
        elif isinstance(source, MPS):
            # the chain stays where the caller put it: a seq or dp walk
            # moves it to the session's device once, a tensor-parallel walk
            # copies only this rank's tile of each Γ there
            self._mps = source
            self.n_sites, self.chi, self.d = (source.n_sites, source.chi,
                                              source.phys_dim)
            self._semantics, self._hint = source.semantics, "inmem"
            self._elt_bytes = source.gammas.element_size()
        else:
            raise TypeError(f"source must be an MPS, a GammaStore or a store "
                            f"path — got {type(source).__name__}")

    def plan(self, n_samples: int) -> SessionPlan:
        """The fully-resolved execution plan for ``sample(n_samples, ...)``."""
        with self._lock:
            if n_samples not in self._plans:
                self._plans[n_samples] = resolve_plan(
                    self.config, n_samples=n_samples, n_sites=self.n_sites,
                    chi=self.chi, d=self.d, source_semantics=self._semantics,
                    device=self.device, mesh=self.mesh,
                    backend_hint=self._hint, elt_bytes=self._elt_bytes,
                    runtime=self.runtime)
            return self._plans[n_samples]

    def explain(self, n_samples: int) -> dict:
        """The plan's choices, and for a streamed plan the perfmodel's §3.1
        overlap accounting behind them (``engine.explain_plan``)."""
        plan = self.plan(n_samples)
        stages = plan.stages or ((0, self.n_sites, self.chi),)
        info = {"backend": plan.backend, "runtime": plan.runtime,
                "processes": self.runtime.process_count,
                "scheme": plan.scheme,
                "kernels": plan.kernels, "semantics": plan.semantics,
                "p1": plan.p1, "p2": plan.p2,
                "micro_batch": plan.micro_batch, "n_stages": len(stages),
                "chi_buckets": sorted({c for _, _, c in stages})}
        if plan.backend == "streamed":
            from repro_torch.core.perfmodel import Workload
            from repro_torch.engine.planner import explain_plan
            from repro_torch.engine.streaming import StreamPlan
            w = Workload(n_samples=n_samples, n_sites=self.n_sites,
                         chi=self.chi, d=self.d, macro_batch=n_samples,
                         micro_batch=plan.micro_batch or n_samples)
            more = explain_plan(
                StreamPlan(segment_len=plan.segment_len,
                           micro_batch=plan.micro_batch),
                w, self.config.hardware, compute_bytes=self._elt_bytes)
            more.pop("scheme")
            info.update(more)
            if plan.shard_block:
                from repro_torch.core.perfmodel import shard_wire_bytes
                hosts = self.runtime.process_count
                info["shard"] = {"block": plan.shard_block, "hosts": hosts,
                                 **shard_wire_bytes(w, hosts,
                                                    block=plan.shard_block)}
        return info

    # -- sources, made at most once ------------------------------------------
    def _ensure_mps(self) -> MPS:
        with self._lock:
            if self._mps is None:
                g, lam = self._store.get_segment(0, self.n_sites,
                                                 prefetch_next_segment=False)
                semantics = (self.config.semantics
                             if self.config.semantics != "auto" else "linear")
                self._mps = MPS(g, lam, semantics)
            return self._mps

    def _device_mps(self) -> MPS:
        """The whole chain on the session's device, moved there once."""
        with self._lock:
            if self._dev_mps is None:
                mps = self._ensure_mps()
                self._dev_mps = (mps if mps.device == self.device
                                 else mps.to(self.device))
            return self._dev_mps

    def _ensure_store(self) -> GammaStore:
        with self._lock:
            if self._store is None:
                root = self.config.store_root
                if root is None:
                    root = self._tmp_store_root = tempfile.mkdtemp(
                        prefix="fastmps_session_")
                # the identity storage dtype: the streamed walk sees the
                # in-memory chain's values bit for bit
                dt = self._mps.gammas.dtype
                self._store = GammaStore(root, storage_dtype=dt,
                                         compute_dtype=dt)
                if self._store.n_sites == 0:
                    self._store.write_mps(self._mps)
                self._owns_store = True
            return self._store

    def _default_service(self):
        """The session's private one-lane service: ``sample`` and
        ``run_queue`` are synchronous wrappers over it, so a batch has one
        execution path (the service's batch runner)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("the session is closed")
            if self._service is None:
                from repro_torch.api.service import SamplingService
                self._service = SamplingService(workers=1)
            return self._service

    def sample(self, n_samples: int, key: torch.Tensor, *,
               resume: bool = False, checkpoint_dir: Optional[str] = None,
               stop_after_segments: Optional[int] = None) -> np.ndarray:
        """Draw ``n_samples`` chains; returns (N, M) int64 outcomes.

        A one-batch job on the session's private service, drawn on ``key``
        unchanged.  ``resume=True`` continues a streamed walk from its
        newest checkpoint; ``checkpoint_dir`` overrides the config's;
        ``stop_after_segments`` stops a streamed walk there, as a kill
        would."""
        handle = self._default_service().submit(
            self, n_samples=n_samples, key=key, macro_batches=1,
            resume=resume, checkpoint_dir=checkpoint_dir,
            stop_after_segments=stop_after_segments)
        return handle.result()

    def _execute_batch(self, n_samples: int, key: torch.Tensor, *, job=None,
                       resume: bool = False,
                       checkpoint_dir: Optional[str] = None,
                       stop_after_segments: Optional[int] = None,
                       pipeline: bool = False) -> tuple[np.ndarray, dict]:
        """Run ONE macro batch on the data plane — the service's batch
        runner and the only place a backend is called.  ``key`` is the
        job's key: the local planes fold it (``service.batch_key``), the
        remote plane ships it with the ``job`` identity and the worker
        folds it.  Returns ``(samples, stats)``, the stats by value, so
        concurrent lanes never read another batch's numbers (``self.stats``
        keeps the last walk's for the synchronous facade)."""
        from repro_torch.api.service import batch_key

        if self._closed:
            raise RuntimeError("the session is closed")
        plan = self.plan(n_samples)
        if job is not None and plan.backend != "remote":
            key = batch_key(key, job.batch_id, job.n_batches)
        # the config's checkpoint_dir names ONE walk's directory: a
        # multi-batch job must not fall back to it (every batch would write
        # the same files); checkpoint_root gives per-batch directories
        if checkpoint_dir is None and (job is None or job.n_batches == 1):
            checkpoint_dir = self.config.checkpoint_dir
        req = SampleRequest(
            plan=plan, n_samples=n_samples, key=key, mps=self._device_mps,
            source=self._ensure_mps, tiles=self._tiles,
            store=self._ensure_store, mesh=self.mesh, runtime=self.runtime,
            config=self.config, resume=resume, checkpoint_dir=checkpoint_dir,
            stop_after_segments=stop_after_segments, job=job,
            pipeline=pipeline, engines=self._engines)
        # a lane thread's current card is cuda:0: make it the session's
        with (torch.cuda.device(self.device) if self.device.type == "cuda"
              else contextlib.nullcontext()), \
                (self._mesh_lock if plan.scheme != "seq"
                 else contextlib.nullcontext()):
            out = get_backend(plan.backend).sample(req)
        self.stats = req.stats
        # row-major (N, M), the layout the JAX package's session returns
        return np.ascontiguousarray(out), dict(req.stats)

    def run_queue(self, queue, per_batch: int, base_key: torch.Tensor, *,
                  worker: str = "session",
                  checkpoint_root: Optional[str] = None,
                  on_batch: Optional[Callable[[int, np.ndarray], None]] = None
                  ) -> dict[int, np.ndarray]:
        """Macro batches (paper N₁) as idempotent work items claimed from
        the caller's queue (its state is the restart unit: two sessions on
        one queue split the work): batch b is ``sample(per_batch,
        fold_in(base_key, b))``.  With ``checkpoint_root`` a streamed batch
        checkpoints into its own directory, and a batch killed mid-chain
        resumes from its last segment boundary.  ``on_batch(b, samples)``
        is called per finished batch; without it the samples are
        returned."""
        from repro_torch.api.service import (batch_checkpoint_dir,
                                             has_chain_checkpoint)
        from repro_torch.core import prng

        streamed = self.plan(per_batch).backend == "streamed"
        out: dict[int, np.ndarray] = {}
        while (b := queue.claim(worker)) is not None:
            ck, resume = None, False
            if checkpoint_root and streamed:
                ck = batch_checkpoint_dir(checkpoint_root, b)
                os.makedirs(ck, exist_ok=True)
                resume = has_chain_checkpoint(ck)
            res = self.sample(per_batch, prng.fold_in(base_key, b),
                              resume=resume, checkpoint_dir=ck)
            if on_batch is not None:
                on_batch(b, res)
            else:
                out[b] = res
            if ck:
                shutil.rmtree(ck, ignore_errors=True)   # the batch is out
            queue.complete(b)
        return out

    def close(self) -> None:
        """Release what the session owns: its service lane, its engines, a
        store it opened or wrote (and a temporary store's directory), a
        runtime it resolved from a name, and its reference to the chain; a
        store or runtime passed in stays open."""
        if self._service is not None:
            self._service.close()       # joins the lane: no walk in flight
            self._service = None
        for eng in self._engines.values():
            eng.close(close_store=False)
        self._engines.clear()
        if self._owns_store and self._store is not None:
            self._store.close()
            self._store = None
            self._owns_store = False
        if self._tmp_store_root is not None:
            shutil.rmtree(self._tmp_store_root, ignore_errors=True)
            self._tmp_store_root = None
        if self._owns_runtime and not self._closed:
            self.runtime.close()        # reap its worker processes
        self._mps = self._dev_mps = None
        self._tiles.clear()
        self._closed = True

    def __enter__(self) -> "SamplingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
