"""Train, prefill and serve step factories for the LM stack.

Mirrors ``repro.launch.steps.make_train_step`` / ``make_prefill_step`` /
``make_serve_step``.  The reference's sharding policy (``param_shardings``
and the rest) matters only across devices and is later work (ROADMAP.md
§1 row 19).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import softmax_xent


def loss_and_grads(params: T.Transformer, batch: dict, cfg: T.ModelConfig,
                   aux_weight: float = 0.01):
    """The train step's backward: (loss, aux, grads), grads by reference
    leaf path (``params.ref_leaves()``), each a list of the rows'
    gradients in the weights' dtypes.  The loss is ``softmax_xent(logits,
    labels) + aux_weight·aux``; the forward takes the reference's default
    attention route (``_sdpa``, ``flash=False``: the flash kernel has no
    backward) under ``cfg.remat_policy``, with ``frames``/``patches`` from
    the batch.  The weights require grad for this backward alone."""
    extra = {k: batch[k] for k in ("frames", "patches") if k in batch}
    leaves = params.ref_leaves()
    flat = [t for leaf in leaves.values() for t in leaf.tensors]
    try:
        with torch.enable_grad():
            params.requires_grad_(True)
            logits, aux = T.forward(params, batch["tokens"], cfg, extra,
                                    flash=False)
            loss = softmax_xent(logits, batch["labels"])
            del logits
            grads = torch.autograd.grad(loss + aux_weight * aux, flat,
                                        allow_unused=True)
    finally:
        params.requires_grad_(False)
    rows = iter(torch.zeros_like(t) if g is None else g
                for t, g in zip(flat, grads))
    by_leaf = {path: [next(rows) for _ in leaf.tensors]
               for path, leaf in leaves.items()}
    return loss.detach(), aux.detach(), by_leaf


def make_train_step(cfg: T.ModelConfig, optimizer, aux_weight: float = 0.01,
                    grad_compression_axis: Optional[str] = None):
    """(params, opt_state, batch) → (params, opt_state, metrics), the
    parameters and the optimizer state updated in place (the reference
    donates them).  Gradients from :func:`loss_and_grads`.  metrics:
    ``loss`` (the cross entropy), ``aux`` and ``gnorm`` = √Σ over every
    leaf of its fp32 gradient squared, 0-d fp32 tensors.
    ``grad_compression_axis`` is accepted and unused, as in the
    reference."""
    del grad_compression_axis

    def train_step(params, opt_state, batch):
        loss, aux, grads = loss_and_grads(params, batch, cfg, aux_weight)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for rows in grads.values() for g in rows))
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, "aux": aux, "gnorm": gnorm}
    return train_step


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
