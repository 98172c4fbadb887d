"""Macro batches as an idempotent work queue (the subset the session's
``run_queue`` and ``launch/sample.py`` use: claim, complete, pending).

Batch b is fully determined by ``(seed, b)``, so a restarted run marks the
batches already on disk complete and computes only the rest.  Requeueing,
stealing and the straggler hooks of ``repro.runtime.elastic`` come with the
service layer (ROADMAP.md §1 row 10).
"""
from __future__ import annotations

from typing import Optional


class WorkQueue:
    """Hands out the lowest batch id that is neither claimed nor done."""

    def __init__(self, n_batches: int):
        self._owner: dict[int, Optional[str]] = {b: None
                                                 for b in range(n_batches)}
        self._done: set[int] = set()

    def claim(self, worker: str) -> Optional[int]:
        for b in sorted(self._owner):
            if self._owner[b] is None and b not in self._done:
                self._owner[b] = worker
                return b
        return None

    def complete(self, b: int) -> bool:
        """Mark batch ``b`` done; a second completion does not count."""
        if b in self._done:
            return False
        self._done.add(b)
        self._owner[b] = None
        return True

    @property
    def pending(self) -> list[int]:
        return [b for b in sorted(self._owner) if b not in self._done]
