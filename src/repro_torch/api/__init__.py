"""Sampling front door of the port: :class:`SamplingSession` over the
``inmem``, ``streamed`` and ``remote`` data planes on the ``local``,
``multihost`` and ``remote`` runtimes (``api/runtime.py``), and the job
service (:class:`SamplingService`) that ``SamplingSession.sample`` and
``run_queue`` wrap: asynchronous jobs over elastic thread or fleet lanes
(see ``api/session.py`` and ``api/service.py``)."""
from repro_torch.api import remote  # noqa: F401  (registers "remote")
from repro_torch.api.backends import (Backend, SampleRequest,
                                      available_backends, get_backend,
                                      register_backend)
from repro_torch.api.config import (AUTO, SamplerConfig, SessionPlan,
                                    resolve_plan)
from repro_torch.api.remote import RemoteRuntime
from repro_torch.api.runtime import (ClusterRuntime, LocalRuntime,
                                     MultiHostRuntime, TorchMultiHostRuntime,
                                     available_runtimes, emulated_cluster,
                                     get_runtime, register_runtime,
                                     resolve_runtime)
from repro_torch.api.service import (JobBatch, JobCancelled, JobHandle,
                                     SamplingService, batch_key)
from repro_torch.api.session import SamplingSession
from repro_torch.runtime.transport import TransportError, WorkerPool

__all__ = [
    "AUTO", "Backend", "ClusterRuntime", "JobBatch", "JobCancelled",
    "JobHandle", "LocalRuntime", "MultiHostRuntime", "RemoteRuntime",
    "SampleRequest", "SamplerConfig", "SamplingService", "SamplingSession",
    "SessionPlan", "TorchMultiHostRuntime", "TransportError", "WorkerPool",
    "available_backends", "available_runtimes", "batch_key", "get_backend",
    "get_runtime", "emulated_cluster", "register_backend",
    "register_runtime", "resolve_plan", "resolve_runtime",
]
