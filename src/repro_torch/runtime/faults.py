"""The structured fault of the data plane (the subset of the JAX package's
``repro.runtime.faults`` that the Γ store and the checkpoints raise).

A :class:`Fault` has a *kind* from a closed set and the context to act on
it (site, store).  :class:`CorruptSegment` carries one: bytes that failed
verification — a torn npz, a digest or checksum mismatch — are rejected
with it instead of being sampled from.  The fault report, dead letters
and the classifier come with the service layer (ROADMAP.md §1 row 10).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

#: the closed set of fault kinds
KINDS = ("corruption", "transport", "poison", "timeout", "resource")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One classified failure event with its context."""
    kind: str
    message: str
    site: Optional[int] = None       # Γ chain site (data-plane faults)
    batch: Optional[int] = None      # macro batch id
    lane: Optional[str] = None       # service lane / worker name
    store: Optional[str] = None      # GammaStore root
    at: float = dataclasses.field(default_factory=time.time)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")


class CorruptSegment(RuntimeError):
    """Bytes failed verification (digest mismatch, torn npz, or a payload
    whose checksum does not match); ``fault.kind`` is ``corruption``."""

    def __init__(self, fault: Fault):
        super().__init__(fault.message)
        self.fault = fault
