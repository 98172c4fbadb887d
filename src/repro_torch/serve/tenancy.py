"""Multi-tenant admission: API keys, quotas, fair-share priority (a copy
of the JAX package's ``repro.serve.tenancy``).

A *tenant* is an API key with a base priority and two quotas — concurrent
executing jobs and concurrently-requested output bytes (``n_samples × M ×
4``, counted as the JAX package counts its int32 sample block, so a
tenants file means the same in both packages; the port's blocks are
int64).  Quotas bound what a
tenant can have *in flight*, not a rate: a 429 (``QuotaExceeded`` →
``Retry-After``) clears as soon as one of the tenant's jobs drains, which
composes with the service's own perfmodel admission control (that one
bounds the device, this one bounds the tenant).

**Fair share.**  The service schedules jobs by (-priority, id).  A tenant
submitting a burst would monopolize the queue at its base priority, so the
table maps base priority → *effective* priority at submit time:
``priority - active_jobs`` — a deficit scheme: each additional in-flight
job demotes the tenant's next one below other tenants at the same base,
interleaving pending work across tenants instead of FIFO-by-tenant.

Config file (``--tenants tenants.json``)::

    {"tenants": [
        {"name": "alice", "api_key": "alice-key", "priority": 10,
         "max_active_jobs": 4, "max_active_bytes": 100000000},
        {"name": "bob", "api_key": "bob-key"}
    ]}

An *open* table (no file) resolves every request — keyed or not — to a
quota-less ``anonymous`` tenant: single-user deployments need no config.
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Optional


class UnknownTenant(KeyError):
    """API key not in the tenant table (gateway → 401)."""


class QuotaExceeded(RuntimeError):
    """Per-tenant quota exhausted (gateway → 429 + Retry-After)."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclasses.dataclass
class Tenant:
    name: str
    api_key: Optional[str] = None
    priority: int = 0
    max_active_jobs: Optional[int] = None
    max_active_bytes: Optional[int] = None
    # live accounting (TenantTable.begin_job/end_job)
    active_jobs: int = 0
    active_bytes: int = 0
    submitted: int = 0
    rejected: int = 0

    def snapshot(self) -> dict:
        return {"name": self.name, "priority": self.priority,
                "active_jobs": self.active_jobs,
                "active_bytes": self.active_bytes,
                "max_active_jobs": self.max_active_jobs,
                "max_active_bytes": self.max_active_bytes,
                "submitted": self.submitted, "rejected": self.rejected}


class TenantTable:
    """Thread-safe tenant registry + quota ledger."""

    def __init__(self, tenants: Optional[list[Tenant]] = None):
        self._lock = threading.Lock()
        self.open = not tenants
        self._anonymous = Tenant(name="anonymous")
        self._by_key: dict[str, Tenant] = {}
        for t in tenants or []:
            if not t.api_key:
                raise ValueError(f"tenant {t.name!r} has no api_key")
            if t.api_key in self._by_key:
                raise ValueError(f"duplicate api_key for {t.name!r}")
            self._by_key[t.api_key] = t

    @classmethod
    def from_json(cls, path: str) -> "TenantTable":
        with open(path) as f:
            doc = json.load(f)
        fields = {f.name for f in dataclasses.fields(Tenant)}
        tenants = []
        for spec in doc.get("tenants", []):
            unknown = set(spec) - fields
            if unknown:
                raise ValueError(f"tenant spec {spec.get('name')!r}: unknown "
                                 f"fields {sorted(unknown)}")
            tenants.append(Tenant(**spec))
        return cls(tenants)

    def resolve(self, api_key: Optional[str]) -> Tenant:
        """API key → tenant; the open table accepts anything."""
        if self.open:
            return self._anonymous
        t = self._by_key.get(api_key or "")
        if t is None:
            raise UnknownTenant("unknown or missing API key")
        return t

    # -- quota ledger --------------------------------------------------------
    def begin_job(self, tenant: Tenant, nbytes: int) -> int:
        """Admit one job of ``nbytes`` requested output; returns the job's
        fair-share *effective priority*.  Raises :class:`QuotaExceeded`
        (without consuming quota) when either quota would be exceeded."""
        with self._lock:
            if (tenant.max_active_jobs is not None
                    and tenant.active_jobs >= tenant.max_active_jobs):
                tenant.rejected += 1
                raise QuotaExceeded(
                    f"tenant {tenant.name!r}: {tenant.active_jobs} active "
                    f"jobs ≥ quota {tenant.max_active_jobs}")
            if (tenant.max_active_bytes is not None
                    and tenant.active_bytes + nbytes
                    > tenant.max_active_bytes):
                tenant.rejected += 1
                raise QuotaExceeded(
                    f"tenant {tenant.name!r}: {tenant.active_bytes + nbytes}"
                    f" active bytes > quota {tenant.max_active_bytes}")
            eff = tenant.priority - tenant.active_jobs
            tenant.active_jobs += 1
            tenant.active_bytes += nbytes
            tenant.submitted += 1
            return eff

    def end_job(self, tenant: Tenant, nbytes: int) -> None:
        with self._lock:
            tenant.active_jobs = max(0, tenant.active_jobs - 1)
            tenant.active_bytes = max(0, tenant.active_bytes - nbytes)

    def stats(self) -> dict:
        with self._lock:
            tenants = ([self._anonymous.snapshot()] if self.open else
                       [t.snapshot() for t in self._by_key.values()])
            return {"open": self.open, "tenants": tenants,
                    "active_jobs": sum(t["active_jobs"] for t in tenants),
                    "rejected": sum(t["rejected"] for t in tenants)}


__all__ = ["QuotaExceeded", "Tenant", "TenantTable", "UnknownTenant"]
