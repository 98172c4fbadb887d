"""Cluster runtimes: where the processes live and how Γ bytes reach them.

This slice carries :class:`LocalRuntime`, one process whose collectives
are no-ops: the streaming engine reads every segment from its own store.
Under ``torch.distributed`` each rank of a job is such a process with its
own engine.  The multi-host broadcast and the remote runtime come with the
cluster layers (ROADMAP.md §1 row 10).
"""
from __future__ import annotations

import contextlib


class LocalRuntime:
    """One process; the collectives the engine calls do nothing."""
    name = "local"
    process_index = 0
    process_count = 1

    @property
    def is_root(self) -> bool:
        return self.process_index == 0

    def io_counters(self) -> dict:
        """Bytes the runtime moved between processes (none here)."""
        return {"broadcast_bytes": 0, "broadcasts": 0}

    def compute_lock(self):
        """Held around one segment's device work (a no-op here)."""
        return contextlib.nullcontext()

    def barrier(self) -> None:
        """Line the processes up (one process: nothing to wait for)."""
