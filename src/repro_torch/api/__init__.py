"""Sampling front door of the port: :class:`SamplingSession` over the
``inmem`` and ``streamed`` data planes on the ``local`` runtime (see
``api/session.py``)."""
from repro_torch.api.backends import (Backend, SampleRequest, get_backend,
                                      register_backend)
from repro_torch.api.config import (AUTO, SamplerConfig, SessionPlan,
                                    resolve_plan)
from repro_torch.api.runtime import LocalRuntime
from repro_torch.api.session import SamplingSession

__all__ = ["AUTO", "Backend", "LocalRuntime", "SampleRequest",
           "SamplerConfig", "SamplingSession", "SessionPlan", "get_backend",
           "register_backend", "resolve_plan"]
