"""Data-plane registry for :class:`repro_torch.api.SamplingSession`.

This slice carries the ``inmem`` data plane: the whole stacked Γ is on the
device; scheme ``seq`` walks it with ``core/sampler`` (micro-batched or not),
``dp``/``tp_single``/``tp_double`` and ``baseline19`` with
``core/parallel`` over the session's mesh.  The dynamic-χ branch waits for
ROADMAP.md §1 row 8; other data planes register the same way when they are
ported (rows 9-10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.config import SessionPlan
from repro_torch.core.mps import MPS

_REGISTRY: dict[str, "Backend"] = {}


def register_backend(name: str) -> Callable[[type], type]:
    """Class decorator: instantiate and register a backend under ``name``."""
    def deco(cls: type) -> type:
        _REGISTRY[name] = cls()
        return cls
    return deco


def get_backend(name: str) -> "Backend":
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"no backend {name!r} registered; "
                         f"have {sorted(_REGISTRY)}") from None


@dataclasses.dataclass
class SampleRequest:
    """Everything a backend needs for one ``sample()`` execution."""
    plan: SessionPlan
    n_samples: int
    key: torch.Tensor
    mps: MPS
    mesh: Optional[object] = None      # launch.mesh.Mesh for dp/tp/[19]


class Backend:
    """One execution strategy for a resolved :class:`SessionPlan`."""
    name = "abstract"

    def sample(self, req: SampleRequest) -> np.ndarray:
        raise NotImplementedError


@register_backend("inmem")
class InMemBackend(Backend):
    """Whole chain on the device (paper §3.1–§3.2 in-memory paths)."""
    name = "inmem"

    def sample(self, req: SampleRequest) -> np.ndarray:
        from repro_torch.core import parallel as PP
        from repro_torch.core import sampler as S

        plan, cfg, n = req.plan, req.plan.sampler_config, req.n_samples
        if plan.scheme == "seq":
            if plan.micro_batch is not None:
                out = S.sample_batched(req.mps, n, req.key, plan.micro_batch,
                                       cfg)
            else:
                out = S.sample(req.mps, n, req.key, cfg)
        elif plan.scheme == "baseline19":
            out = PP._baseline19_sample(req.mesh, req.mps, n, req.key, cfg)
        else:
            out = PP._multilevel_sample(req.mesh, req.mps, n, req.key,
                                        plan.pconfig, cfg)
        return out.cpu().numpy()
