"""Data-plane registry for :class:`repro_torch.api.SamplingSession`.

This slice carries the ``inmem`` data plane's ``seq`` branch: the whole
stacked Γ is on the device and the chain is walked by ``core/sampler``
(micro-batched or not).  Other data planes register the same way when they
are ported (ROADMAP.md §1 rows 9-10).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

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


class Backend:
    """One execution strategy for a resolved :class:`SessionPlan`."""
    name = "abstract"

    def sample(self, req: SampleRequest) -> np.ndarray:
        raise NotImplementedError


@register_backend("inmem")
class InMemBackend(Backend):
    """Whole chain on the device, walked by ``core/sampler`` (scheme seq)."""
    name = "inmem"

    def sample(self, req: SampleRequest) -> np.ndarray:
        from repro_torch.core import sampler as S

        plan, cfg = req.plan, req.plan.sampler_config
        if plan.micro_batch is not None:
            out = S.sample_batched(req.mps, req.n_samples, req.key,
                                   plan.micro_batch, cfg)
        else:
            out = S.sample(req.mps, req.n_samples, req.key, cfg)
        return out.cpu().numpy()
