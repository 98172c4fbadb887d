"""Kernel dispatch: one registry for the site-step stage.

Implementations register under ``(stage, semantics, backend)`` with backend

- ``"torch"`` — the plain PyTorch cell, op for op with the JAX package's
  ``xla`` cell (runs on any device);
- ``"cuda"``  — the hand-written Hopper kernel (CUDA tensors only).

``resolve_kernels("auto" | "cuda" | "torch", device)`` picks the backend:
AUTO means ``cuda`` for tensors on the card and ``torch`` on the CPU.

Unlike the JAX package's registry there is no silent fallback: a ``cuda``
request on a CPU tensor, or a stage with no ``cuda`` cell, raises.
"""
from __future__ import annotations

from typing import Callable

import torch

KERNEL_MODES = ("auto", "cuda", "torch")

_REGISTRY: dict[tuple[str, str, str], Callable] = {}


def register_site_op(stage: str, semantics: str, backend: str):
    """Decorator: register ``fn`` as the ``backend`` implementation of
    ``stage`` under ``semantics`` ("linear" | "born")."""
    def deco(fn: Callable) -> Callable:
        _REGISTRY[(stage, semantics, backend)] = fn
        return fn
    return deco


def get_site_op(stage: str, semantics: str, backend: str) -> Callable:
    """The implementation registered for one cell; raises if there is none."""
    try:
        return _REGISTRY[(stage, semantics, backend)]
    except KeyError:
        raise ValueError(
            f"no implementation for stage={stage!r} semantics={semantics!r} "
            f"backend={backend!r}; registered: {sorted(_REGISTRY)}") from None


def registered_ops() -> list[tuple[str, str, str]]:
    return sorted(_REGISTRY)


def resolve_kernels(requested: str, device) -> str:
    """``"auto" | "cuda" | "torch"`` → a concrete backend for tensors on
    ``device``; a ``cuda`` request for the CPU raises."""
    if requested not in KERNEL_MODES:
        raise ValueError(f"kernels must be one of {KERNEL_MODES}, "
                         f"got {requested!r}")
    on_card = torch.device(device).type == "cuda"
    if requested == "auto":
        return "cuda" if on_card else "torch"
    if requested == "cuda" and not on_card:
        raise ValueError("kernels='cuda' needs tensors on a CUDA device; "
                         f"got device {device}")
    return requested


from repro_torch.kernels import site_impls  # noqa: E402,F401  (registers ops)
