"""Elastic scaling: macro batches as an idempotent work queue.

The paper's data-parallel scheme makes every macro batch independent —
batch b is fully determined by (seed, b).  That makes elasticity exact:
when the worker set changes (a lost node, a scale-up) the pending batch
ids are re-partitioned, completed work is never recomputed, and results do
not depend on which worker ran what.  This is the host-side control
plane; the data plane (the chain walk on the card) is untouched.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional


def partition_batches(batch_ids: Iterable[int], workers: list[str]
                      ) -> dict[str, list[int]]:
    """Deterministic round-robin partition of pending batches over
    workers."""
    out: dict[str, list[int]] = {w: [] for w in workers}
    for i, b in enumerate(sorted(batch_ids)):
        out[workers[i % len(workers)]].append(b)
    return out


@dataclasses.dataclass
class BatchRecord:
    batch_id: int
    owner: Optional[str] = None
    started_at: Optional[float] = None
    done: bool = False
    attempts: int = 0     # hand-outs (claims + steals): the retry bound


class WorkQueue:
    """Idempotent macro-batch queue with failure and elasticity semantics.

    * ``claim(worker)`` re-offers requeued batches (FIFO) before the lowest
      fresh unclaimed batch, so work orphaned by a lost worker is never
      starved behind fresh batches.
    * ``fail(worker)`` / ``remove_worker`` requeue what the worker held.
    * ``complete(b, worker=...)`` is ownership-checked: a removed worker's
      late completion of a requeued batch is rejected, not counted twice.
    * ``add_worker`` makes a worker eligible to claim.
    * ``reclaim_stale(timeout)`` is the straggler hook (``stragglers.py``).
    * ``stats()`` is the progress snapshot with a stable schema:
      ``total``/``done``/``claimed``/``requeued``/``pending``/``claims``/
      ``requeues``/``workers``, every key always present.
    * ``observer`` is the telemetry seam (``repro_torch.obs.metrics``): an
      optional callable invoked as ``observer(event, batch=b, worker=w)``
      for ``claim`` / ``requeue`` / ``complete`` / ``steal``.  Its errors
      are swallowed: telemetry never changes scheduling.
    """

    def __init__(self, n_batches: int, seed: int = 0, observer=None):
        self.seed = seed
        self.observer = observer
        self.records = {b: BatchRecord(b) for b in range(n_batches)}
        self.workers: set[str] = set()
        self._requeued: list[int] = []     # FIFO of re-offer-first batch ids
        self._claims = 0
        self._requeues = 0

    def _emit(self, event: str, **fields) -> None:
        if self.observer is not None:
            try:
                self.observer(event, **fields)
            except Exception:              # noqa: BLE001 — see docstring
                pass

    # -- membership ----------------------------------------------------------
    def add_worker(self, w: str) -> None:
        self.workers.add(w)

    def _requeue(self, r: BatchRecord) -> None:
        r.owner, r.started_at = None, None
        if r.batch_id not in self._requeued:
            self._requeued.append(r.batch_id)
            self._requeues += 1
            self._emit("requeue", batch=r.batch_id)

    def remove_worker(self, w: str) -> None:
        self.workers.discard(w)
        for r in self.records.values():
            if r.owner == w and not r.done:
                self._requeue(r)

    # -- work ----------------------------------------------------------------
    def _hand_out(self, r: BatchRecord, w: str, now: Optional[float]) -> int:
        r.owner = w
        r.started_at = now if now is not None else time.monotonic()
        r.attempts += 1
        self._claims += 1
        self._emit("claim", batch=r.batch_id, worker=w)
        return r.batch_id

    def attempts(self, b: int) -> int:
        """Hand-outs of batch ``b``: what the service's bounded retries
        (``max_batch_attempts``) are measured against."""
        return self.records[b].attempts

    def claim(self, w: str, now: Optional[float] = None) -> Optional[int]:
        if w not in self.workers:
            self.add_worker(w)
        while self._requeued:              # orphaned work first, FIFO
            r = self.records[self._requeued.pop(0)]
            if r.owner is not None or r.done:   # a stale entry
                continue
            return self._hand_out(r, w, now)
        for b in sorted(self.records):
            r = self.records[b]
            if r.owner is None and not r.done:
                return self._hand_out(r, w, now)
        return None

    def complete(self, b: int, worker: Optional[str] = None) -> bool:
        """Mark batch ``b`` done; returns whether the completion counted.

        With ``worker``, a completion from a worker that no longer owns the
        batch is rejected (the current owner's identical result lands
        instead).  A batch completes at most once: a second delivery
        (straggler duplicate, transport replay) reports False."""
        r = self.records[b]
        if r.done:
            return False
        if worker is not None and r.owner != worker:
            return False
        r.done = True
        r.owner = None
        self._emit("complete", batch=b, worker=worker)
        return True

    def fail(self, w: str) -> None:
        self.remove_worker(w)

    def steal(self, b: int, w: str, now: Optional[float] = None) -> bool:
        """Hand a reclaimed (unowned, not done) batch to ``w``, the
        straggler duplicate.  Counts as a claim and drops the batch from
        the re-offer FIFO, so ``claim`` does not hand it out again."""
        r = self.records[b]
        if r.done or r.owner is not None:
            return False
        if b in self._requeued:
            self._requeued.remove(b)
        if w not in self.workers:
            self.add_worker(w)
        self._hand_out(r, w, now)
        self._emit("steal", batch=b, worker=w)
        return True

    def reclaim_stale(self, timeout: float, now: Optional[float] = None
                      ) -> list[int]:
        now = now if now is not None else time.monotonic()
        out = []
        for r in self.records.values():
            if r.owner is not None and not r.done and \
                    now - r.started_at > timeout:
                self._requeue(r)
                out.append(r.batch_id)
        return out

    def stats(self) -> dict:
        """Progress snapshot: the counts a service's ``progress`` reports."""
        done = sum(r.done for r in self.records.values())
        claimed = sum(r.owner is not None and not r.done
                      for r in self.records.values())
        return {"total": len(self.records), "done": done, "claimed": claimed,
                "requeued": len([b for b in self._requeued
                                 if not self.records[b].done]),
                "pending": len(self.records) - done,
                "claims": self._claims, "requeues": self._requeues,
                "workers": len(self.workers)}

    @property
    def pending(self) -> list[int]:
        return [b for b, r in sorted(self.records.items()) if not r.done]

    @property
    def finished(self) -> bool:
        return all(r.done for r in self.records.values())
