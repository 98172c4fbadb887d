"""`SamplingService` — the async job front door over `SamplingSession`.

The paper's central property — every macro batch is an independent,
restart-exact unit of work (batch = f(seed, id)) — is exactly what a
serving system needs, so this module turns sampling into *jobs*:

    with api.SamplingService(workers=2) as svc:
        h = svc.submit(store_path, cfg, n_samples=4096,
                       key=prng.key(0), macro_batches=4)
        for batch_id, block in h.stream():      # blocks as they complete
            persist(batch_id, block)
        # or: samples = h.result()              # blocking concatenation

A job is decomposed into its N₁ macro batches and fed through an elastic
:class:`repro_torch.runtime.elastic.WorkQueue` — ONE job/batch table that
every lane, local or remote, claims from.  A **lane** comes in two kinds:

* **thread lanes** (default): threads driving the session's data plane in
  this process.  They share the card: their kernels go to the same
  (default) stream, and a session's streamed engine walks one batch at a
  time;
* **fleet lanes** (``pool=``): each lane owns one *persistent worker
  process* in a :class:`repro_torch.runtime.transport.WorkerPool`; a
  claimed batch is serialized as the v2 job-batch payload
  (``repro_torch.api.remote``) and dispatched over the framed-pipe RPC,
  and the worker — alive across batches, its sessions and kernels
  loaded — streams the block back.
  A transport fault (worker death, dropped result, deadline) is a *lane*
  fault, never a job fault: the batch requeues, the worker respawns, and
  the recomputation is bit-identical.

The queue's guarantees hold verbatim either way:

* batches rebalance on worker loss (:meth:`SamplingService.remove_worker`
  requeues the victim's in-flight batches; a late result from the removed
  worker is discarded by the queue's ownership check — the recomputation
  is bit-identical anyway),
* completed work is never recomputed,
* results are owner- and order-independent.

**Scheduling.**  Jobs are served in priority order (higher ``priority``
first, FIFO within a priority); requeued batches are re-offered before
fresh ones (``WorkQueue`` fairness).  Same-(source, config)-cell jobs
**coalesce onto one session** — one resolved plan, one jit cache, one
streamed engine — so a burst of small requests against one store never
rebuilds an engine.  Multi-batch streamed jobs run **gang-scheduled**: the
engine prefetches macro batch b+1's first Γ segment (local read or §3.1
broadcast) while batch b's tail still computes.

**Straggler mitigation** (``runtime/stragglers``): each job tracks an
EWMA of its batch completion times; when a lane finds nothing fresh to
claim, a batch whose owner has exceeded ``straggler_k × EWMA`` is
*reclaimed* and re-issued to the idle lane (Eq. 1's ``N·(max−mean)`` tail,
statistically removed).  The late original's completion is rejected by the
ownership check — idempotent batches make the duplicate harmless, and the
bits are identical whichever copy lands.

**Admission control.**  ``max_active_bytes`` caps the *modeled* resident
footprint (``core/perfmodel``'s Eq. 3)
of concurrently-running jobs: a burst of large jobs queues in priority
order instead of thrashing one device budget, with the backpressure
surfaced in :meth:`stats` (``admission``: queued vs admitted jobs, active
model bytes).  One job is always admitted, so a job larger than the
budget still runs — alone.

**Key schedule** (:func:`batch_key`): a single-batch job draws with the
job key itself — so ``SamplingSession.sample`` (a one-job synchronous
wrapper over this service) draws what the session drew before the service
existed; a k-batch job draws batch b with
``fold_in(key, b)`` — the ``run_queue`` schedule, so streamed blocks are
bit-identical per seed to one-shot ``session.sample`` calls.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Iterable, Iterator, Optional

import numpy as np

from repro_torch.runtime.elastic import WorkQueue
from repro_torch.runtime.faults import (KINDS, CrashLoopLane, DeadLetter,
                                        Fault, FaultReport, classify,
                                        dead_letter_kind)
from repro_torch.runtime.stragglers import StragglerMitigator

# job lifecycle states (JobHandle.status())
PENDING, RUNNING, DONE, FAILED, CANCELLED = (
    "pending", "running", "done", "failed", "cancelled")


class JobCancelled(RuntimeError):
    """Raised by ``result()``/``stream()`` of a cancelled job."""


def batch_key(key, batch_id: int, n_batches: int):
    """The job → macro-batch PRNG schedule (one definition, used by the
    local execution path and by the remote worker decoding a job payload).

    A 1-batch job IS the one-shot call: its key passes through untouched,
    so ``session.sample(n, key)`` draws on ``key``.  A k-batch job derives
    batch b's key as ``fold_in(key, b)``, the macro-batch schedule of
    ``run_queue`` and ``launch/sample.py``, so batch = f(seed, id)."""
    from repro_torch.core import prng

    if n_batches == 1:
        return key
    return prng.fold_in(key, batch_id)


def batch_checkpoint_dir(root: str, batch_id: int) -> str:
    """The per-batch checkpoint subdirectory convention — ONE definition
    shared by the service scheduler and ``session.run_queue`` so their
    mid-chain restarts interoperate."""
    return os.path.join(root, f"batch_{batch_id:05d}")


def has_chain_checkpoint(ck_dir: str) -> bool:
    """Whether a per-batch checkpoint dir holds a resumable mid-chain
    state (the engine's ``site_*`` files)."""
    return any(f.startswith("site_") for f in os.listdir(ck_dir))


def _mesh_ranks(mesh) -> int:
    out = 1
    for size in dict(mesh.shape).values():
        out *= int(size)
    return out


@dataclasses.dataclass(frozen=True)
class JobBatch:
    """Identity of one macro batch of one job — the unit a worker executes
    and (fleet lanes / ``backend="remote"``) the unit the transport
    dispatches (see ``repro_torch.api.remote.build_payload``)."""
    job_id: int
    batch_id: int
    n_batches: int


@dataclasses.dataclass
class _Job:
    job_id: int
    session: Any                       # the (maybe coalesced) SamplingSession
    n_samples: int                     # total over all batches
    per_batch: int
    n_batches: int
    key: Any
    priority: int
    queue: WorkQueue
    straggler: StragglerMitigator
    skip: frozenset
    state: str = PENDING
    error: Optional[BaseException] = None
    # fault history (runtime/faults.Fault records) + the dead-letter record
    # set when bounded retries exhaust a poison batch
    faults: list = dataclasses.field(default_factory=list)
    dead_letter: Optional[dict] = None
    blocks: dict = dataclasses.field(default_factory=dict)
    batch_stats: dict = dataclasses.field(default_factory=dict)
    # perfmodel admission numbers (Eq. 3 resident bytes of one active
    # batch; total modeled compute seconds over the job's batches)
    model_bytes: float = 0.0
    model_compute_s: float = 0.0
    # single-batch session.sample passthroughs
    resume: bool = False
    checkpoint_dir: Optional[str] = None
    stop_after_segments: Optional[int] = None
    # multi-batch fault tolerance: per-batch checkpoint subdirs + auto-resume
    checkpoint_root: Optional[str] = None

    @property
    def expected(self) -> list[int]:
        return [b for b in range(self.n_batches) if b not in self.skip]


class JobHandle:
    """The caller's view of one submitted job."""

    def __init__(self, service: "SamplingService", job: _Job):
        self._service = service
        self._job = job

    @property
    def job_id(self) -> int:
        return self._job.job_id

    def status(self) -> str:
        """One of pending | running | done | failed | cancelled."""
        with self._service._cond:
            return self._job.state

    @property
    def progress(self) -> dict:
        """Snapshot: batch counts + the underlying ``WorkQueue.stats()`` +
        straggler/admission numbers."""
        with self._service._cond:
            out = self._job.queue.stats()
            out.update(state=self._job.state,
                       skipped=len(self._job.skip),
                       blocks=len(self._job.blocks),
                       faults=len(self._job.faults),
                       model_bytes=self._job.model_bytes,
                       model_compute_s=self._job.model_compute_s)
            out.update(self._job.straggler.stats())
            return out

    def fault_report(self) -> Optional[dict]:
        """Structured fault history of this job, or None when fault-free:
        the per-attempt :class:`~repro_torch.runtime.faults.Fault` records,
        kind
        counts, and — when bounded retries exhausted a poison batch — the
        dead-letter record (``batch``/``attempts``/``kind``)."""
        with self._service._cond:
            job = self._job
            if not job.faults and job.dead_letter is None:
                return None
            return FaultReport(faults=list(job.faults),
                               dead_letter=job.dead_letter).to_dict()

    def cancel(self) -> bool:
        """Stop scheduling this job's remaining batches.  Returns whether
        the cancel landed (a finished/failed job reports False).  An
        in-flight batch is not interrupted; its result is discarded."""
        svc = self._service
        with svc._cond:
            if self._job.state in (DONE, FAILED, CANCELLED):
                return self._job.state == CANCELLED
            svc._finish(self._job, CANCELLED)
            svc._cond.notify_all()
            return True

    def stream(self, timeout: Optional[float] = None
               ) -> Iterator[tuple[int, np.ndarray]]:
        """Yield ``(batch_id, samples)`` per macro batch, in batch order, as
        batches complete.  The concatenation of the yielded blocks is
        bit-identical per seed to the one-shot path (see :func:`batch_key`).
        ``timeout`` is a per-batch deadline (a busy service notifies the
        condition constantly; the clock must not re-arm on every wake).
        Raises the job's error / :class:`JobCancelled` mid-iteration."""
        import time as _time

        svc = self._service
        job = self._job
        for b in job.expected:
            deadline = (None if timeout is None
                        else _time.monotonic() + timeout)
            with svc._cond:
                while b not in job.blocks:
                    if job.state == FAILED:
                        raise job.error
                    if job.state == CANCELLED:
                        raise JobCancelled(
                            f"job {job.job_id} cancelled after "
                            f"{len(job.blocks)}/{len(job.expected)} batches")
                    remaining = (None if deadline is None
                                 else deadline - _time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"job {job.job_id}: batch {b} not done within "
                            f"{timeout}s")
                    svc._cond.wait(timeout=remaining)
                block = job.blocks[b]
            yield b, block

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the job finishes; returns the (N, M) concatenation
        of its macro-batch blocks in batch order."""
        blocks = [blk for _, blk in self.stream(timeout=timeout)]
        if not blocks:
            raise ValueError(f"job {self.job_id} has no batches to run "
                             f"(all {len(self._job.skip)} skipped)")
        return np.concatenate(blocks, axis=0)

    @property
    def stats(self) -> dict:
        """Per-batch engine/runtime statistics (batch_id → stats dict)."""
        with self._service._cond:
            return {b: dict(s) for b, s in self._job.batch_stats.items()}


class SamplingService:
    """Job scheduler over the session registries; see module docstring.

    ``workers`` — initial lane count.  ``pool`` — fleet mode: ``True``
    builds a service-owned :class:`~repro_torch.runtime.transport.WorkerPool`,
    or pass a configured pool; every lane then drives one persistent
    worker process.  ``device`` — where the sessions the service builds for
    submitted sources run (None: the card; a fleet pool's workers take
    theirs from the pool).  ``straggler_k`` — the EWMA deadline multiplier for
    straggler reclaim (``None`` disables stealing; completions are still
    observed).  ``max_active_bytes`` — perfmodel admission budget
    (``None`` = unlimited).  ``steal_poll_s`` — how often an idle lane
    re-checks for stale batches when everything is claimed.
    ``max_batch_attempts`` — bounded-retry/dead-letter policy: a batch
    handed out this many times without completing fails its job with a
    :class:`~repro_torch.runtime.faults.DeadLetter` (kind=poison for repeat
    worker kills) instead of retrying forever.  ``lane_quarantine_s`` —
    cooldown before a crash-looping lane (``LaneHealth`` tripped on
    respawn) is readmitted.

    ``observer`` is the telemetry seam (``repro_torch.obs.metrics``): an
    optional callable invoked as ``observer(event, **fields)`` for
    ``job_submit`` / ``job_finished(state=...)`` /
    ``batch_done(duration_s=..., stats=...)`` / ``steal`` /
    ``rejected_result`` / ``lane_fault`` / ``fault(kind=...)`` /
    ``lane_quarantine(worker=...)`` / ``lane_readmit(worker=...)`` /
    ``queue_{claim,requeue,
    complete,steal}`` (per-job WorkQueue events, prefix-forwarded).
    Observer errors are swallowed — telemetry must never perturb
    scheduling.  Also settable after construction (``svc.observer =``).
    """

    def __init__(self, *, workers: int = 1, pool=None, device=None,
                 straggler_k: Optional[float] = 3.0,
                 steal_poll_s: float = 0.05,
                 max_active_bytes: Optional[float] = None,
                 max_batch_attempts: int = 3,
                 lane_quarantine_s: float = 5.0,
                 observer=None):
        self.observer = observer
        self.device = device
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._jobs: dict[int, _Job] = {}
        self._order: list[int] = []            # job ids, (-priority, id) order
        self._sessions: dict = {}              # coalescing cache (owned)
        self._threads: dict[str, threading.Thread] = {}
        self._removed: set[str] = set()
        self._closing = False
        self._seq = itertools.count()
        self._worker_seq = itertools.count()
        self._coalesced = 0
        self.straggler_k = straggler_k
        self.steal_poll_s = steal_poll_s
        self.max_active_bytes = max_active_bytes
        self._owns_pool = pool is True
        if pool is True:
            from repro_torch.runtime.transport import WorkerPool
            pool = WorkerPool()
        self._pool = pool
        self._lane_batches: dict[str, int] = {}
        self._steals = 0                       # straggler re-issues handed out
        self._rejected_results = 0             # late completions discarded
        self._transport_faults = 0             # lane faults absorbed
        # fault taxonomy + dead-letter / lane-quarantine policy
        self.max_batch_attempts = max_batch_attempts
        self.lane_quarantine_s = lane_quarantine_s
        self._fault_counts = {k: 0 for k in KINDS}
        self._dead_letters = 0
        self._quarantined: dict[str, float] = {}   # lane → readmit monotonic
        self._lane_quarantines = 0
        self._lane_readmits = 0
        self._readmit_timers: list[threading.Timer] = []
        # test/ops hook: called as hook(job, batch_id, worker) right after a
        # worker claims a batch, before it executes — failure-injection
        # (tests), progress taps, tracing
        self.batch_hook = None
        for _ in range(workers):
            self.add_worker()

    @property
    def pool(self):
        """The fleet :class:`~repro_torch.runtime.transport.WorkerPool` backing
        the lanes, or None for thread lanes (telemetry binders hook its
        ``observer`` here)."""
        return self._pool

    def _emit(self, event: str, **fields) -> None:
        if self.observer is not None:
            try:
                self.observer(event, **fields)
            except Exception:          # noqa: BLE001 — see class docstring
                pass

    def _finish(self, job: _Job, state: str) -> None:
        """Set a terminal job state (caller holds the lock) + telemetry."""
        job.state = state
        self._emit("job_finished", state=state)

    def _record_fault(self, job: _Job, fault: Fault) -> None:
        """Caller holds the lock: append to the job's fault history and the
        service-wide per-kind counters + telemetry (``fault`` event)."""
        job.faults.append(fault)
        self._fault_counts[fault.kind] += 1
        self._emit("fault", kind=fault.kind)

    def _queue_observer(self, event: str, **fields) -> None:
        """Per-job WorkQueue events, forwarded with a ``queue_`` prefix so
        one bound observer sees the whole scheduling surface."""
        self._emit("queue_" + event, **fields)

    # -- membership (elastic worker lanes) -----------------------------------
    def add_worker(self, name: Optional[str] = None) -> str:
        """Add one lane (scale-up is claim eligibility, nothing else); in
        fleet mode this also spawns the lane's persistent worker process."""
        with self._cond:
            if self._closing:
                raise RuntimeError("service is closed")
            if len(self.workers()) >= 1:
                # the same invariant submit() enforces, from the other side:
                # a multi-process runtime's broadcast schedule must stay
                # deterministic, so its jobs own the single lane exclusively
                for jid in self._order:
                    job = self._jobs[jid]
                    if (job.state in (PENDING, RUNNING)
                            and job.session.runtime.process_count > 1):
                        raise ValueError(
                            f"job {job.job_id} runs on the multi-process "
                            f"runtime {job.session.runtime.name!r} — scale-"
                            f"up would interleave its broadcast collectives "
                            f"across lanes; wait for it to finish")
            name = name or f"lane-{next(self._worker_seq)}"
            old = self._threads.get(name)
            if old is not None:
                # a removed-and-exited lane may be revived under its stable
                # ops name; a live one (even mid-drain) may not — two
                # threads must never share a lane identity
                if name in self._removed and not old.is_alive():
                    del self._threads[name]
                    self._removed.discard(name)
                else:
                    raise ValueError(f"worker {name!r} already exists")
            if self._pool is not None:
                w = self._pool.workers.get(name)
                if w is None or not w.alive:
                    self._pool.respawn(name)
            t = threading.Thread(target=self._worker_loop, args=(name,),
                                 name=f"sampling-service-{name}", daemon=True)
            self._threads[name] = t
            t.start()
            return name

    def remove_worker(self, name: str) -> None:
        """Drop a lane; its claimed batches requeue immediately (the queue
        re-offers them before fresh work) and any result it still produces
        is discarded by the ownership check — elasticity is exact because
        batches are idempotent.  A fleet lane's worker process is killed
        (its in-flight call fails over to the requeue path)."""
        with self._cond:
            self._removed.add(name)
            for jid in self._order:
                job = self._jobs[jid]
                if job.state in (PENDING, RUNNING):
                    job.queue.remove_worker(name)
            if self._pool is not None:
                self._pool.reap(name, kill=True)
            self._cond.notify_all()

    def workers(self) -> list[str]:
        with self._cond:
            return [n for n in self._threads if n not in self._removed]

    # -- lane health: crash-loop quarantine ----------------------------------
    def _quarantine_lane(self, name: str) -> None:
        """Crash-loop response (``LaneHealth`` tripped): retire the lane NOW
        — its batches requeue, its worker process is reaped — and schedule a
        cooldown readmit.  The cooldown IS the penalty: the lane returns to
        service with a clean fault window instead of respawning hot
        forever."""
        with self._cond:
            if self._closing or name in self._quarantined:
                return
            self._lane_quarantines += 1
            self._quarantined[name] = time.monotonic() + self.lane_quarantine_s
            if self._pool is not None:
                self._pool.health.forgive(name)
        self._emit("lane_quarantine", worker=name)
        self.remove_worker(name)
        t = threading.Timer(self.lane_quarantine_s, self._readmit_lane,
                            args=(name,))
        t.daemon = True
        with self._cond:
            if self._closing:
                return
            self._readmit_timers.append(t)
        t.start()

    def _readmit_lane(self, name: str) -> None:
        """Cooldown expiry: bring a quarantined lane back under its stable
        ops name (fresh worker process, clean fault window)."""
        with self._cond:
            self._quarantined.pop(name, None)
            if self._closing:
                return
            old = self._threads.get(name)
        if old is not None and old.is_alive():
            old.join(timeout=30)
        try:
            self.add_worker(name)
        except (ValueError, RuntimeError):
            return          # revived meanwhile, or the service closed
        with self._cond:
            self._lane_readmits += 1
        self._emit("lane_readmit", worker=name)

    # -- submission ----------------------------------------------------------
    def submit(self, source, config=None, *, n_samples: int, key,
               mesh=None, macro_batches: int = 1, priority: int = 0,
               skip_batches: Iterable[int] = (),
               resume: bool = False, checkpoint_dir: Optional[str] = None,
               stop_after_segments: Optional[int] = None,
               checkpoint_root: Optional[str] = None) -> JobHandle:
        """Queue one sampling job; returns immediately with a handle.

        ``source`` is anything a :class:`SamplingSession` accepts (MPS,
        GammaStore, store path) — jobs with an equal (source, config, mesh)
        triple coalesce onto one service-owned session, i.e. one resolved
        plan/jit cache — or an existing session (``config``/``mesh`` must
        then be None; the caller keeps ownership).

        ``n_samples`` is the job total; it divides over ``macro_batches``
        (paper N₁), each a restart-exact work item keyed by
        ``batch_key(key, b, macro_batches)``.  ``skip_batches`` marks batch
        ids already done elsewhere (idempotent restart: the CLI skips
        batches whose output files exist).  ``priority``: higher runs
        first.  ``resume``/``checkpoint_dir``/``stop_after_segments`` are
        the single-batch session passthroughs; ``checkpoint_root`` gives a
        multi-batch streamed job per-batch checkpoint subdirs with
        automatic mid-chain resume (the ``run_queue`` contract).
        """
        from repro_torch.api.session import SamplingSession
        from repro_torch.core.perfmodel import Workload, job_admission_cost

        if macro_batches < 1:
            raise ValueError(f"macro_batches must be ≥ 1, got "
                             f"{macro_batches}")
        if n_samples % macro_batches:
            raise ValueError(f"n_samples={n_samples} must divide over "
                             f"{macro_batches} macro batches")
        skip = frozenset(int(b) for b in skip_batches)
        if any(b < 0 or b >= macro_batches for b in skip):
            raise ValueError(f"skip_batches {sorted(skip)} outside "
                             f"[0, {macro_batches})")
        if macro_batches > 1 and (resume or checkpoint_dir
                                  or stop_after_segments is not None):
            raise ValueError(
                "resume/checkpoint_dir/stop_after_segments address ONE "
                "chain walk — for a multi-batch job use checkpoint_root "
                "(per-batch subdirs, automatic resume)")
        if checkpoint_root and (resume or checkpoint_dir):
            raise ValueError(
                "checkpoint_root manages per-batch checkpoint dirs and "
                "resume automatically — don't combine it with "
                "resume/checkpoint_dir")

        if isinstance(source, SamplingSession):
            if config is not None or mesh is not None:
                raise ValueError("submitting an existing session: config/"
                                 "mesh are the session's — pass None")
            session = source
        else:
            session = self._coalesce_session(source, config, mesh)
        per_batch = n_samples // macro_batches
        # resolve (and validate) the plan up front: config errors surface at
        # submit time on the caller's thread, never as a failed job
        plan = session.plan(per_batch)
        if session.runtime.process_count > 1 and len(self.workers()) > 1:
            # every process of a multi-process runtime must issue its
            # broadcast collectives in the same order; one lane walking
            # jobs in the deterministic (-priority, id) order guarantees
            # that — concurrent lanes would interleave per thread timing
            # and desync (or deadlock) the cluster
            raise ValueError(
                f"runtime {session.runtime.name!r} spans "
                f"{session.runtime.process_count} processes — drive it "
                f"from a single-lane service (workers=1), not "
                f"{len(self.workers())} lanes, so the broadcast schedule "
                f"stays deterministic across processes")
        if (session.mesh is not None and len(self.workers()) > 1
                and _mesh_ranks(session.mesh) > 1):
            # the same for a mesh over several torch.distributed ranks:
            # every rank must run the walks' collectives in one order
            raise ValueError(
                f"the session's mesh spans {_mesh_ranks(session.mesh)} ranks "
                f"— drive it from a single-lane service (workers=1), not "
                f"{len(self.workers())} lanes, so every rank walks the "
                f"batches in the same order")
        if self._pool is not None:
            # fleet lanes ship the v2 job-batch payload; the session side
            # must stay dispatchable (local single-process resolution, no
            # local chain-walk state — per-batch idempotence IS the remote
            # fault tolerance, exactly the backend="remote" contract)
            if (session.runtime.process_count > 1
                    or session.runtime.name not in ("local", "remote")):
                raise ValueError(
                    f"fleet lanes dispatch serialized job batches — the "
                    f"submitting session must resolve on a single-process "
                    f"local runtime, not {session.runtime.name!r}")
            if plan.scheme != "seq":
                raise ValueError(
                    f"fleet lanes resolve placement on the worker — submit "
                    f"with scheme AUTO/'seq', not {plan.scheme!r}")
            if (resume or checkpoint_dir or checkpoint_root
                    or stop_after_segments is not None):
                raise ValueError(
                    "fleet lanes have no local chain walk: per-batch "
                    "idempotence is the fault-tolerance story — restart "
                    "with skip_batches instead of resume/checkpoint options")

        w = Workload(n_samples=per_batch, n_sites=session.n_sites,
                     chi=session.chi, d=session.d, macro_batch=per_batch,
                     micro_batch=(plan.micro_batch or per_batch),
                     bytes_per_elt=session._elt_bytes)
        cost = job_admission_cost(w, session.config.hardware,
                                  n_batches=macro_batches - len(skip))

        with self._cond:
            if self._closing:
                raise RuntimeError("service is closed")
            queue = WorkQueue(macro_batches, observer=self._queue_observer)
            job = _Job(job_id=next(self._seq), session=session,
                       n_samples=n_samples, per_batch=per_batch,
                       n_batches=macro_batches, key=key, priority=priority,
                       queue=queue,
                       straggler=StragglerMitigator(
                           queue, k=(self.straggler_k or 3.0)),
                       skip=skip,
                       model_bytes=cost["resident_bytes"],
                       model_compute_s=cost["compute_s"],
                       resume=resume, checkpoint_dir=checkpoint_dir,
                       stop_after_segments=stop_after_segments,
                       checkpoint_root=checkpoint_root)
            self._emit("job_submit")
            for b in skip:
                job.queue.complete(b)
            if job.queue.finished:
                self._finish(job, DONE)
            self._jobs[job.job_id] = job
            self._order.append(job.job_id)
            self._order.sort(key=lambda j: (-self._jobs[j].priority, j))
            self._cond.notify_all()
        return JobHandle(self, job)

    def _coalesce_session(self, source, config, mesh):
        """One session (→ one resolved plan / streamed engine) per
        (source, config, mesh) cell, owned by the service."""
        from repro_torch.api.runtime import dtype_name
        from repro_torch.api.session import SamplingSession
        from repro_torch.data.gamma_store import GammaStore

        if isinstance(source, GammaStore):
            # dtypes are per-open constructor state, not recoverable from
            # the root — two handles on one root with different precision
            # must NOT share a session (bit-identity per handle)
            token = ("store", os.path.realpath(str(source.root)),
                     dtype_name(source.storage_dtype),
                     dtype_name(source.compute_dtype))
        elif isinstance(source, (str, os.PathLike)):
            token = ("store-path", os.path.realpath(str(source)))
        else:
            token = ("obj", id(source))
        cell = (token, config, mesh)
        with self._cond:
            sess = self._sessions.get(cell)
            if sess is not None:
                self._coalesced += 1
                return sess
        # build outside the lock (store probing does I/O)
        # fleet lanes walk in their workers: the session here only plans
        # and hands over the store, so it needs no card
        device = self.device
        if device is None and self._pool is not None:
            device = "cpu"
        sess = SamplingSession(source, config, mesh=mesh, device=device)
        with self._cond:
            race = self._sessions.get(cell)
            if race is not None:
                self._coalesced += 1
                sess.close()
                return race
            self._sessions[cell] = sess
            return sess

    # -- scheduling ----------------------------------------------------------
    def _admission_view(self) -> tuple[list[int], list[int], float]:
        """(admitted job ids in schedule order, jobs queued by admission,
        modeled active bytes).  Caller holds the lock.  RUNNING jobs are
        grandfathered; PENDING jobs are admitted in priority order while
        the modeled footprint fits — and one job is always admitted, so a
        job bigger than the whole budget still runs, alone."""
        budget = self.max_active_bytes
        admitted: list[int] = []
        waiting: list[int] = []
        active = 0.0
        for jid in self._order:
            job = self._jobs[jid]
            if job.state == RUNNING:
                active += job.model_bytes
                admitted.append(jid)
        for jid in self._order:
            job = self._jobs[jid]
            if job.state != PENDING:
                continue
            if (budget is None or not admitted
                    or active + job.model_bytes <= budget):
                active += job.model_bytes
                admitted.append(jid)
            else:
                waiting.append(jid)
        return admitted, waiting, active

    def _next_task(self, worker: str) -> Optional[tuple[_Job, int]]:
        """Highest-priority claimable batch among *admitted* jobs (requeued
        before fresh within a job, courtesy of the WorkQueue); when nothing
        is claimable, a batch whose owner blew the EWMA deadline is stolen
        (straggler reclaim — last resort, it duplicates compute).  Caller
        holds the lock."""
        admitted, _, _ = self._admission_view()
        admitted_set = set(admitted)
        for jid in self._order:
            if jid not in admitted_set:
                continue
            job = self._jobs[jid]
            if job.state not in (PENDING, RUNNING):
                continue
            b = job.queue.claim(worker)
            if b is not None:
                job.state = RUNNING
                return job, b
        if self.straggler_k:
            for jid in self._order:
                job = self._jobs[jid]
                if job.state != RUNNING:
                    continue
                b = job.straggler.maybe_steal(worker)
                if b is not None:
                    self._steals += 1
                    self._emit("steal")
                    self._record_fault(job, Fault(
                        kind="timeout", batch=b,
                        message=f"straggler reclaim: batch {b} re-issued to "
                                f"{worker} after its owner exceeded the "
                                f"EWMA deadline"))
                    return job, b
        return None

    def _stealable(self) -> bool:
        """Whether an idle lane should poll for stale batches (a RUNNING
        job with claimed batches and an armed deadline).  Caller holds the
        lock."""
        if not self.straggler_k:
            return False
        for jid in self._order:
            job = self._jobs[jid]
            if (job.state == RUNNING
                    and job.straggler.deadline is not None
                    and any(r.owner is not None and not r.done
                            for r in job.queue.records.values())):
                return True
        return False

    def _worker_loop(self, name: str) -> None:
        while True:
            with self._cond:
                task = None
                while task is None:
                    if self._closing or name in self._removed:
                        return
                    task = self._next_task(name)
                    if task is None:
                        # an idle lane wakes on notify (new work) — or on a
                        # short poll when a straggler deadline might pass
                        self._cond.wait(timeout=(self.steal_poll_s
                                                 if self._stealable()
                                                 else None))
            self._run_batch(*task, worker=name)

    def _batch_checkpoint(self, job: _Job, b: int
                          ) -> tuple[Optional[str], bool]:
        """Per-batch checkpoint dir + whether to resume (run_queue contract:
        durable batch output supersedes the chain checkpoint).
        ``checkpoint_root`` applies to 1-batch jobs too, so the CLI's
        ``--service --macro-batches 1`` keeps the synchronous path's
        mid-chain fault tolerance."""
        if job.checkpoint_root:
            if job.session.plan(job.per_batch).backend != "streamed":
                return None, False
            ck = batch_checkpoint_dir(job.checkpoint_root, b)
            os.makedirs(ck, exist_ok=True)
            return ck, has_chain_checkpoint(ck)
        return job.checkpoint_dir, job.resume

    def _run_batch_fleet(self, job: _Job, b: int, worker: str
                         ) -> tuple[np.ndarray, dict]:
        """Dispatch one claimed batch through the lane's persistent worker
        process: serialize the v2 job-batch payload (base key + batch
        identity; the worker folds the batch key itself) and block for the
        streamed-back block."""
        from repro_torch.api.remote import build_payload

        store = job.session._ensure_store()     # locks internally; does I/O
        payload = build_payload(job.session.config, store, job.per_batch,
                                job.key,
                                job=JobBatch(job.job_id, b, job.n_batches))
        out = self._pool.call(worker, payload)
        w = self._pool.workers.get(worker)
        # the worker's walk stats and kernel launches ride its result header
        stats = dict(getattr(w, "last_stats", None) or {})
        if "log_prob" in stats:
            stats["log_prob"] = np.asarray(stats["log_prob"],
                                           dtype=np.float64)
        stats.update(transport_worker=worker,
                     transport_worker_batches=w.batches if w else None,
                     launches=dict(getattr(w, "last_launches", None) or {}))
        return out, stats

    def _run_batch(self, job: _Job, b: int, worker: str) -> None:
        from repro_torch.runtime.transport import TransportError

        hook = self.batch_hook
        if hook is not None:
            hook(job, b, worker)       # may remove this worker / cancel
        with self._cond:
            if job.state != RUNNING or worker in self._removed:
                return                 # cancelled/failed meanwhile, or killed
            # gang-scheduling: keep the streamed engine's prefetch pool warm
            # across the batch boundary only while SOMEONE still has a later
            # walk to run — the job's last batch must not pin a speculative
            # segment (pending includes this batch; a concurrent finisher
            # only costs one extra prefetch, the pre-fix behaviour)
            pipeline = job.queue.stats()["pending"] > 1
        ck = None
        t0 = time.monotonic()
        try:
            if self._pool is not None:
                out, stats = self._run_batch_fleet(job, b, worker)
            else:
                ck, resume = self._batch_checkpoint(job, b)
                out, stats = job.session._execute_batch(
                    job.per_batch, job.key,
                    job=JobBatch(job.job_id, b, job.n_batches),
                    resume=resume, checkpoint_dir=ck,
                    stop_after_segments=job.stop_after_segments,
                    pipeline=pipeline)
        except TransportError as e:
            # a LANE fault, not a job fault: the batch requeues (re-offered
            # before fresh work) and the lane's worker process respawns —
            # the recomputation is bit-identical (batch = f(seed, id)).
            # Unless the batch itself keeps killing lanes: after
            # max_batch_attempts hand-outs it dead-letters its JOB
            # (kind=poison) so one bad payload can't crash-loop the fleet.
            fault = classify(e, batch=b, lane=worker) or Fault(
                kind="transport", message=str(e), batch=b, lane=worker)
            with self._cond:
                self._transport_faults += 1
                self._emit("lane_fault")
                self._record_fault(job, fault)
                if job.queue.records[b].owner == worker:
                    job.queue.fail(worker)
                attempts = job.queue.attempts(b)
                if (job.state == RUNNING and not job.queue.records[b].done
                        and attempts >= self.max_batch_attempts):
                    kind = dead_letter_kind(
                        [f for f in job.faults if f.batch == b])
                    dl = Fault(kind=kind, batch=b, lane=worker,
                               message=f"batch {b} dead-lettered after "
                                       f"{attempts} attempts "
                                       f"(last: {fault.message})")
                    self._record_fault(job, dl)
                    job.dead_letter = {"batch": b, "attempts": attempts,
                                       "kind": kind}
                    job.error = DeadLetter(dl, FaultReport(
                        faults=list(job.faults),
                        dead_letter=job.dead_letter))
                    self._dead_letters += 1
                    self._finish(job, FAILED)
                self._cond.notify_all()
                if self._closing or worker in self._removed:
                    return
            try:
                self._pool.respawn(worker)
            except CrashLoopLane:
                self._quarantine_lane(worker)  # crash-looping: cool it down
            except OSError:
                self.remove_worker(worker)     # can't respawn: retire lane
            return
        except BaseException as e:     # noqa: BLE001 — reported via the job
            with self._cond:
                fault = classify(e, batch=b, lane=worker)
                if fault is not None:          # corruption/timeout/resource
                    self._record_fault(job, fault)
                if job.queue.records[b].owner == worker:
                    self._finish(job, FAILED)
                    job.error = e
                self._cond.notify_all()
            return
        duration = time.monotonic() - t0
        with self._cond:
            if not job.queue.complete(b, worker=worker):
                self._rejected_results += 1
                self._emit("rejected_result")
                return                 # ownership lost mid-compute: discard —
                                       # the requeued batch recomputes the
                                       # exact same block (batch = f(seed, id))
            job.straggler.observe_completion(duration)
            self._lane_batches[worker] = self._lane_batches.get(worker, 0) + 1
            self._emit("batch_done", duration_s=duration, stats=stats)
            if job.state == CANCELLED:
                return
            job.blocks[b] = np.asarray(out)
            job.batch_stats[b] = stats
            if job.queue.finished and job.state == RUNNING:
                self._finish(job, DONE)
            self._cond.notify_all()
        if ck is not None and job.checkpoint_root:
            import shutil
            shutil.rmtree(ck, ignore_errors=True)   # batch output is durable

    # -- introspection -------------------------------------------------------
    def stats(self) -> dict:
        """Service-wide snapshot with a STABLE schema — every key below is
        present on every call, zero-valued on an idle service, so scrapers
        (``repro_torch.obs.metrics``) never branch
        on missing keys:

        * ``jobs`` — count per lifecycle state, **all five states always
          present**: ``{"pending": 0, "running": 0, "done": 0,
          "failed": 0, "cancelled": 0, ...}``
        * ``sessions`` / ``coalesced_jobs`` — coalescing cache size, hits
        * ``workers`` — live lane count
        * ``queue_depth`` — pending batches over all active jobs
        * ``lane_batches`` — batches completed per lane name
        * ``admission`` — ``budget_bytes`` (None = unlimited),
          ``active_model_bytes``, ``admitted_jobs``, ``queued_jobs``,
          ``backpressure`` (bool)
        * ``stragglers`` — ``duplicates``, ``steals``, ``rejected_results``
        * ``faults`` / ``dead_letters`` — fault-taxonomy counters: every
          :data:`~repro_torch.runtime.faults.KINDS` kind always present (zero
          when clean) + jobs failed by the bounded-retry dead-letter policy
        * ``transport`` — ALWAYS present: ``enabled`` (fleet mode?) plus
          the :meth:`WorkerPool.stats` keys (``workers``/``spawned``/
          ``reaped``/``faults``/``batches``/``dispatch_bytes``/
          ``lane_window_faults``/``backoff_seconds``, zeroed for thread
          lanes), ``lane_faults`` (faults absorbed by lanes), and the
          crash-loop surface: ``quarantined`` (lane names on cooldown),
          ``lane_quarantines`` / ``lane_readmits``.
        """
        with self._cond:
            states = {s: 0 for s in
                      (PENDING, RUNNING, DONE, FAILED, CANCELLED)}
            queue_depth = 0
            duplicates = 0
            for job in self._jobs.values():
                states[job.state] += 1
                if job.state in (PENDING, RUNNING):
                    queue_depth += job.queue.stats()["pending"]
                duplicates += job.straggler.duplicates
            admitted, waiting, active_bytes = self._admission_view()
            if self._pool is not None:
                transport = dict(self._pool.stats(), enabled=True)
            else:
                transport = {"enabled": False, "workers": 0, "spawned": 0,
                             "reaped": 0, "faults": 0, "batches": {},
                             "dispatch_bytes": 0, "lane_window_faults": {},
                             "backoff_seconds": 0.0}
            transport["lane_faults"] = self._transport_faults
            transport["quarantined"] = sorted(self._quarantined)
            transport["lane_quarantines"] = self._lane_quarantines
            transport["lane_readmits"] = self._lane_readmits
            return {"jobs": states, "sessions": len(self._sessions),
                    "faults": dict(self._fault_counts),
                    "dead_letters": self._dead_letters,
                    "coalesced_jobs": self._coalesced,
                    "workers": len(self.workers()),
                    "queue_depth": queue_depth,
                    "lane_batches": dict(self._lane_batches),
                    "admission": {
                        "budget_bytes": self.max_active_bytes,
                        "active_model_bytes": active_bytes,
                        "admitted_jobs": len(admitted),
                        "queued_jobs": len(waiting),
                        "backpressure": bool(waiting)},
                    "stragglers": {
                        "duplicates": duplicates, "steals": self._steals,
                        "rejected_results": self._rejected_results},
                    "transport": transport}

    def purge(self) -> int:
        """Drop finished (done/failed/cancelled) jobs from the service
        table; returns how many were dropped.  A long-lived serving process
        calls this periodically so consumed jobs' sample blocks don't
        accumulate for the service's lifetime.  Handles the caller still
        holds keep answering (each handle owns its job record) — the blocks'
        memory is reclaimed once those handles go away.  The service never
        purges on its own: dropping results the caller hasn't consumed is
        the caller's decision."""
        with self._cond:
            dead = [j for j, job in self._jobs.items()
                    if job.state in (DONE, FAILED, CANCELLED)]
            for j in dead:
                del self._jobs[j]
            self._order = [j for j in self._order if j in self._jobs]
            return len(dead)

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Stop the lanes (running batches finish; pending jobs that never
        completed report cancelled), reap fleet workers, and close
        service-owned sessions."""
        with self._cond:
            if self._closing:
                return
            self._closing = True
            for job in self._jobs.values():
                if job.state in (PENDING, RUNNING):
                    self._finish(job, CANCELLED)
            timers = list(self._readmit_timers)
            self._cond.notify_all()
        for t in timers:
            t.cancel()
        for t in self._threads.values():
            t.join(timeout=300)
        if self._pool is not None:
            for name in list(self._threads):
                self._pool.reap(name)
            if self._owns_pool:
                self._pool.close()
        for sess in self._sessions.values():
            sess.close()
        self._sessions.clear()

    def __enter__(self) -> "SamplingService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = ["CANCELLED", "DONE", "FAILED", "JobBatch", "JobCancelled",
           "JobHandle", "PENDING", "RUNNING", "SamplingService", "batch_key"]
