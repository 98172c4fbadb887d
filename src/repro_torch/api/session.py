"""`SamplingSession` — the port's front door for chain sampling.

The session owns an in-memory :class:`MPS` on its device, resolves a
:class:`SamplerConfig` against it, and routes ``sample(n, key)`` to the
registered data plane::

    from repro_torch import api
    from repro_torch.core import prng

    with api.SamplingSession(mps) as session:          # on the CUDA card
        samples = session.sample(4096, prng.key(0))    # (N, M) outcomes

``device`` defaults to the card; without a GPU the session raises unless
``device="cpu"`` is passed.  ``mesh`` (``launch.mesh.make_mesh``) places the
walk over DP × TP ranks: every rank of the job builds the same session and
calls ``sample`` with the same key, and every rank gets the full (N, M)
array back, as the JAX package's controller does; the session then runs on
the mesh's device.  Without a mesh the session walks the chain in this
process (scheme ``seq``).  ``sample`` uses its key unchanged (the JAX
package's one-batch service job); ``run_queue`` derives macro batch b's key
as ``fold_in(base, b)``.  The service layer is a later slice.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.api.backends import SampleRequest, get_backend
from repro_torch.api.config import (SamplerConfig, SessionPlan, resolve_plan,
                                    unported)
from repro_torch.core import prng
from repro_torch.core.mps import MPS
from repro_torch.device import DeviceLike, resolve_device


class SamplingSession:
    """Facade over the data-plane registry; see module docstring."""

    def __init__(self, source: MPS, config: Optional[SamplerConfig] = None,
                 *, device: DeviceLike = None, mesh=None):
        if not isinstance(source, MPS):
            raise unported(f"a {type(source).__name__} source (only an "
                           f"in-memory MPS is)", 9,
                           "GammaStore + streaming engine")
        self.config = config or SamplerConfig()
        self.mesh = mesh
        self.device = (resolve_device(device) if device is not None
                       or mesh is None else mesh.device)
        # moving is explicit here: the chain lives on the session's device
        self._mps: Optional[MPS] = (source if source.device == self.device
                                    else source.to(self.device))
        self.n_sites, self.chi, self.d = (source.n_sites, source.chi,
                                          source.phys_dim)
        self._semantics = source.semantics
        self._plans: dict[int, SessionPlan] = {}

    def plan(self, n_samples: int) -> SessionPlan:
        """The fully-resolved execution plan for ``sample(n_samples, ...)``."""
        if n_samples not in self._plans:
            self._plans[n_samples] = resolve_plan(
                self.config, n_samples=n_samples, n_sites=self.n_sites,
                chi=self.chi, d=self.d, source_semantics=self._semantics,
                device=self.device, mesh=self.mesh)
        return self._plans[n_samples]

    def sample(self, n_samples: int, key: torch.Tensor) -> np.ndarray:
        """Draw ``n_samples`` chains; returns (N, M) int64 outcomes."""
        if self._mps is None:
            raise RuntimeError("the session is closed")
        plan = self.plan(n_samples)
        req = SampleRequest(plan=plan, n_samples=n_samples, key=key,
                            mps=self._mps, mesh=self.mesh)
        return get_backend(plan.backend).sample(req)

    def run_queue(self, queue, per_batch: int, base_key: torch.Tensor, *,
                  worker: str = "session",
                  on_batch: Optional[Callable[[int, np.ndarray], None]] = None
                  ) -> dict[int, np.ndarray]:
        """Macro batches (paper N₁) as idempotent work items: batch b is
        ``sample(per_batch, fold_in(base_key, b))``.  ``on_batch(b, samples)``
        is called per finished batch; without it the samples are returned."""
        out: dict[int, np.ndarray] = {}
        while (b := queue.claim(worker)) is not None:
            res = self.sample(per_batch, prng.fold_in(base_key, b))
            if on_batch is not None:
                on_batch(b, res)
            else:
                out[b] = res
            queue.complete(b)
        return out

    def close(self) -> None:
        """Drop the session's reference to the chain (its device memory is
        freed once the caller drops theirs)."""
        self._mps = None

    def __enter__(self) -> "SamplingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
