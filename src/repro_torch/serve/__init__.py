"""`repro_torch.serve` — the multi-tenant HTTP front door over
`SamplingService` (the JAX package's ``repro.serve``).

Three pieces, each testable alone:

* :mod:`repro_torch.serve.cache` — the content-addressed result cache.
  A batch is a function of (seed, batch id), so sampling is a pure
  function of (store bytes, resolved config, seed, n_samples,
  macro_batches): identical requests are served from cached bytes, and a
  request identical to one still running attaches to its stream.
* :mod:`repro_torch.serve.tenancy` — API key → tenant, per-tenant job and
  byte quotas (429 + Retry-After when spent), fair-share priority.
* :mod:`repro_torch.serve.gateway` — the stdlib ``ThreadingHTTPServer``
  gateway: jobs submitted, watched and cancelled as JSON, sample blocks
  streamed over chunked HTTP in the transport's frames, ``/v1/stats`` and
  the Prometheus ``/metrics``.
"""
from repro_torch.serve.cache import ResultCache, cache_key
from repro_torch.serve.gateway import Gateway
from repro_torch.serve.tenancy import (QuotaExceeded, Tenant, TenantTable,
                                       UnknownTenant)

__all__ = ["Gateway", "QuotaExceeded", "ResultCache", "Tenant",
           "TenantTable", "UnknownTenant", "cache_key"]
