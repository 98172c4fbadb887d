"""Structured fault taxonomy: one failure model for the whole stack.

Every failure the system survives — a rotted Γ site file, a corrupt wire
frame, a worker death, a straggler reclaim, a payload that keeps killing
its worker — folds into one :class:`Fault` with a *kind* from a closed set
and the context to act on it (site, batch, lane, store).  Faults ride the
job state through ``SamplingService.stats()``, ``JobHandle.fault_report``
and the ``MetricsRegistry`` labels.

Kinds (:data:`KINDS`):

* ``corruption`` — bytes failed verification: a Γ site whose digest does
  not match the manifest, a torn npz, a wire payload whose checksum does
  not match.  The file is quarantined (``*.quarantine``).
* ``transport`` — the fleet's RPC plane faulted: worker death, a dropped
  result, a broken pipe, a ``torch.distributed`` backend or network error.
  The batch requeues and recomputes bit for bit (batch = f(seed, id)).
* ``poison`` — one payload kept killing its worker: after
  ``max_batch_attempts`` the batch dead-letters its job.
* ``timeout`` — a deadline fired: the RPC response deadline, a process
  group's timeout, or a straggler's claim reclaimed by the EWMA deadline.
* ``resource`` — the host or the card ran out of something (memory, disk,
  file descriptors); ``torch.OutOfMemoryError`` lands here.

:class:`FaultError` is an exception carrying a :class:`Fault`;
:class:`CorruptSegment` (data plane), :class:`DeadLetter` (a job failed by
bounded retries, with its :class:`FaultReport`) and :class:`CrashLoopLane`
(a lane past its fault window) specialise it.  :func:`classify` folds
foreign exceptions into a :class:`Fault`, so callers never branch on
exception classes twice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

#: the closed set of fault kinds — metrics label values, report keys
KINDS = ("corruption", "transport", "poison", "timeout", "resource")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One classified failure event with its context."""
    kind: str
    message: str
    site: Optional[int] = None       # Γ chain site (data-plane faults)
    batch: Optional[int] = None      # macro batch id (fleet faults)
    lane: Optional[str] = None       # service lane / pool worker name
    store: Optional[str] = None      # GammaStore root (data-plane faults)
    at: float = dataclasses.field(default_factory=time.time)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")

    def to_dict(self) -> dict:
        """JSON-safe dict; context keys without a value are left out."""
        out = {"kind": self.kind, "message": self.message, "at": self.at}
        for k in ("site", "batch", "lane", "store"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out

    def with_context(self, **ctx) -> "Fault":
        """A copy with the missing context fields filled in (context the
        fault already carries is never overwritten)."""
        updates = {k: v for k, v in ctx.items()
                   if v is not None and getattr(self, k, None) is None}
        return dataclasses.replace(self, **updates) if updates else self


@dataclasses.dataclass
class FaultReport:
    """The fault history of one job: what ``JobHandle.fault_report``
    serves and what a dead-lettered job fails with."""
    faults: list = dataclasses.field(default_factory=list)
    dead_letter: Optional[dict] = None   # {batch, attempts, kind}

    def add(self, fault: Fault) -> None:
        self.faults.append(fault)

    def counts(self) -> dict:
        out = {k: 0 for k in KINDS}
        for f in self.faults:
            out[f.kind] += 1
        return out

    def to_dict(self) -> dict:
        return {"faults": [f.to_dict() for f in self.faults],
                "counts": self.counts(),
                "dead_letter": self.dead_letter}


class FaultError(RuntimeError):
    """An exception carrying a structured :class:`Fault`."""

    def __init__(self, fault: Fault):
        super().__init__(fault.message)
        self.fault = fault


class CorruptSegment(FaultError):
    """Bytes failed verification: a digest mismatch, a torn npz, or a wire
    payload whose checksum does not match.  kind=corruption."""


class DeadLetter(FaultError):
    """A batch exhausted ``max_batch_attempts`` and failed its job;
    :attr:`report` is the job's whole :class:`FaultReport`."""

    def __init__(self, fault: Fault, report: FaultReport):
        super().__init__(fault)
        self.report = report


class CrashLoopLane(FaultError):
    """A lane exceeded its fault window: quarantine it (with a cooldown
    readmit) instead of respawning it hot."""


def _dist_errors() -> tuple:
    """``torch.distributed``'s error classes (a backend, network or store
    fault of a process group)."""
    import torch.distributed as dist
    return tuple(c for c in (getattr(dist, "DistError", None),)
                 if c is not None)


def classify(exc: BaseException, **context) -> Optional[Fault]:
    """Fold an exception into a :class:`Fault`, or None for an exception
    that is not an infrastructure fault (a bad config or a numerical check
    stays a job error).

    torch's errors map as the JAX package maps jax's: an out-of-memory
    error of the card (``torch.OutOfMemoryError``) is ``resource``; a
    ``torch.distributed`` error is ``timeout`` when its message says the
    group timed out, else ``transport``.  ``context`` (site= / batch= /
    lane= / store=) fills in what the exception did not record."""
    import torch

    if isinstance(exc, FaultError):
        return exc.fault.with_context(**context)
    # imported here: transport pulls in subprocess machinery, and faults
    # stays importable from the data plane without it
    from repro_torch.runtime.transport import TransportError, WorkerDied
    if isinstance(exc, WorkerDied):
        return Fault(kind="transport", message=str(exc), **context)
    if isinstance(exc, TransportError):
        kind = "timeout" if "deadline" in str(exc) else "transport"
        return Fault(kind=kind, message=str(exc), **context)
    if isinstance(exc, torch.OutOfMemoryError):
        return Fault(kind="resource", message=f"{type(exc).__name__}: {exc}",
                     **context)
    dist_errors = _dist_errors()
    if dist_errors and isinstance(exc, dist_errors):
        text = str(exc).lower()
        kind = "timeout" if ("timed out" in text or "timeout" in text) \
            else "transport"
        return Fault(kind=kind, message=f"{type(exc).__name__}: {exc}",
                     **context)
    if isinstance(exc, TimeoutError):
        return Fault(kind="timeout", message=str(exc), **context)
    if isinstance(exc, (MemoryError, OSError)):
        return Fault(kind="resource", message=f"{type(exc).__name__}: {exc}",
                     **context)
    return None


def dead_letter_kind(batch_faults: list) -> str:
    """The kind a dead-lettered batch fails with: ``poison`` when the
    payload took its worker down at least twice (the crash-loop
    signature), else the batch's dominant kind."""
    crashes = sum(1 for f in batch_faults if f.kind == "transport")
    if crashes >= 2:
        return "poison"
    if not batch_faults:
        return "transport"
    tally: dict[str, int] = {}
    for f in batch_faults:
        tally[f.kind] = tally.get(f.kind, 0) + 1
    return max(tally, key=lambda k: (tally[k], k))


__all__ = ["KINDS", "Fault", "FaultReport", "FaultError", "CorruptSegment",
           "DeadLetter", "CrashLoopLane", "classify", "dead_letter_kind"]
