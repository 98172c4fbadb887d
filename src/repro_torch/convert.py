"""Weights carried across: numpy arrays (e.g. a JAX MPS) → the port's MPS.

Parity tests build every MPS in the JAX package and hand it over through
numpy, so both packages sample the very same chain.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mps import MPS
from repro_torch.device import DeviceLike, resolve_device


def tensor_from_array(a, device: DeviceLike = None) -> torch.Tensor:
    """Copy an array-like (numpy, or anything ``np.asarray`` takes,
    complex128 included) into a tensor on ``device``."""
    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def mps_from_arrays(gammas, lambdas, semantics: str = "linear",
                    device: DeviceLike = None) -> MPS:
    """``gammas (M, χ, χ, d)``, ``lambdas (M, χ)`` arrays → ``MPS``."""
    if semantics not in ("linear", "born"):
        raise ValueError(f"semantics must be 'linear' or 'born', "
                         f"got {semantics!r}")
    g = tensor_from_array(gammas, device)
    lam = tensor_from_array(lambdas, device)
    if g.ndim != 4 or lam.shape != g.shape[:2]:
        raise ValueError(f"expected gammas (M, χ, χ, d) and lambdas (M, χ); "
                         f"got {tuple(g.shape)} and {tuple(lam.shape)}")
    return MPS(g, lam, semantics)
