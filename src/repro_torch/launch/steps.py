"""Prefill and serve step factories for the LM stack.

Mirrors ``repro.launch.steps.make_prefill_step`` / ``make_serve_step``.
The sharding policy and ``make_train_step`` are later work (ROADMAP.md §1
rows 18 and 19).
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T


def make_prefill_step(cfg: T.ModelConfig, kernels: str = "auto"):
    """(params, batch) → last-position logits (B, V).  ``batch`` holds
    ``tokens`` and, for encdec and the VLM, ``frames`` or ``patches`` (the
    stub frontends' embeddings).  Full-sequence and cross attention (the
    hybrid's shared block, whisper's encoder too) go through the flash
    kernel's dispatch (``kernels``)."""
    def prefill(params, batch):
        extra = {k: batch[k] for k in ("frames", "patches") if k in batch}
        logits, _ = T.forward(params, batch["tokens"], cfg, extra,
                              kernels=kernels)
        return logits[:, -1, :]
    return prefill


def make_serve_step(cfg: T.ModelConfig):
    """One decode token: (params, batch, state) → (next_tokens (B, 1)
    int32, state).  Greedy: the first index of the largest logit.
    ``batch`` holds ``tokens`` and, for encdec and the VLM, ``enc_out``
    (``models.transformer.encode``'s output) or ``patches``; their
    cross-attention goes through the flash kernel on the card."""
    def serve_step(params, batch, state: T.DecodeState):
        extra = {k: batch[k] for k in ("enc_out", "patches") if k in batch}
        logits, new_state = T.decode_step(params, batch["tokens"], state, cfg,
                                          extra)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return nxt, new_state
    return serve_step
