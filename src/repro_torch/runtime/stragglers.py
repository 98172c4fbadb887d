"""Straggler mitigation: deadline-based work stealing over the WorkQueue.

Eq. 1 of the [19] pipeline pays ``N·(max − mean)`` for stragglers.
FastMPS's data parallelism removes the structural coupling, and this
module the statistical tail: a batch that runs past ``deadline = k ×
EWMA(batch time)`` is reissued to an idle worker, and the first completion
wins (idempotent batches make duplicates harmless).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.runtime.elastic import WorkQueue


@dataclasses.dataclass
class StragglerMitigator:
    queue: WorkQueue
    k: float = 3.0                 # deadline multiplier
    ewma_alpha: float = 0.2
    _ewma: Optional[float] = None
    duplicates: int = 0            # batches reissued

    def observe_completion(self, duration: float) -> None:
        self._ewma = (duration if self._ewma is None
                      else self.ewma_alpha * duration
                      + (1 - self.ewma_alpha) * self._ewma)

    @property
    def deadline(self) -> Optional[float]:
        return None if self._ewma is None else self.k * self._ewma

    def maybe_steal(self, idle_worker: str, now: Optional[float] = None
                    ) -> Optional[int]:
        """Give an idle worker a late batch to duplicate, if there is one.

        ``reclaim_stale`` requeues every batch past the deadline (its owner
        loses the claim, so a late completion is rejected); the first is
        handed to the idle worker with :meth:`WorkQueue.steal`, the rest
        are re-offered by ordinary claims."""
        if self.deadline is None:
            return None
        for b in self.queue.reclaim_stale(self.deadline, now):
            if self.queue.steal(b, idle_worker, now):
                self.duplicates += 1
                return b
        return None

    def stats(self) -> dict:
        """Snapshot merged into a job's ``progress``."""
        return {"ewma_s": self._ewma, "deadline_s": self.deadline,
                "duplicates": self.duplicates}
