"""Continuous-batching LM server (the paper's §5 analogy).

The FastMPS macro-batch work queue becomes a *request* queue, the left
environment becomes the KV (latent, SSM state) cache, and slot management
replaces macro-batch scheduling:

  * a fixed pool of B cache slots; each active slot decodes one request;
  * when a request finishes (EOS token, its length, or a full cache), its
    slot is refilled at once from the waiting queue: the batch never
    drains;
  * refill zeroes that slot's cache rows and position;
  * per-slot positions (B,): each row writes its own cache index and has
    its own causal mask.

Mirrors ``repro.launch.serve_lm``.  The reference vmaps a scalar-position
decode over the slots; here the batch decodes with per-row positions
directly (``models.transformer.decode_step``), which gives the same tokens.
As the reference, the host reads the tokens back every step.

Usage (on the card; ``--device cpu`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch deepseek-7b \
      --requests 32 --batch 8 --max-new 24
  PYTHONPATH=src python -m repro_torch.launch.serve_lm \
      --arch deepseek-v3-671b --device cpu --requests 8 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch zamba2-7b \
      --device cpu --requests 8 --batch 4

The encoder-decoder and VLM architectures are not served here: their
decode step needs the encoder's output or the image patches, which a
request of this server does not carry, so :func:`serve` refuses them
before the first step (``launch.steps.make_serve_step`` serves them, with
``enc_out`` / ``patches`` in its batch).  The reference's server fails
there with a ``KeyError``.

The MoE architectures decode with MoE capacity counted per batch row, so a
batched step routes each row as the reference's one-row steps do; MLA
keeps its latent cache (``{"latent"}``), mamba2 its fp32 SSM state
(``{"state"}``) and zamba2 both the state and one KV cache per
application of its shared attention block; a refill zeroes each as it
zeroes K and V.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


class SlotState:
    """Host-side bookkeeping for one cache slot."""

    def __init__(self):
        self.request_id: Optional[int] = None
        self.generated: list[int] = []


def make_decode_fn(cfg):
    """(params, tokens (B, 1), caches, positions (B,)) → (next (B, 1),
    caches), the caches written in place.  The greedy token is
    ``models.transformer.greedy``'s: the first largest logit, over the
    ranks' vocabulary columns on a sharded rank (its mesh declared)."""
    def step(params, tokens, caches, positions):
        logits, new = T.decode_step(params, tokens,
                                    T.DecodeState(caches, positions), cfg)
        nxt = T.greedy(params, logits[:, -1, :]).to(torch.int32)
        return nxt[:, None], new.caches
    return step


def _reset_slot(caches, slot: int) -> None:
    for buf in caches.values():          # (L, B, …): zero one slot's rows
        buf[:, slot].zero_()


def serve(cfg, params, prompts, batch: int, max_new: int, cache_len: int,
          eos: Optional[int] = None, verbose: bool = True):
    """Greedy-decode every prompt with continuous batching.

    prompts: per request either a first token (int) or (first_token,
    max_len).  Returns {request_id: [generated tokens]}.
    """
    if cfg.family in ("encdec", "vlm"):
        raise ValueError(
            f"serve() decodes tokens alone; {cfg.name} ({cfg.family}) needs "
            f"{'enc_out' if cfg.family == 'encdec' else 'patches'} in every "
            "step: serve it through launch.steps.make_serve_step with "
            "batch['enc_out'] (models.transformer.encode of the frames) or "
            "batch['patches']")
    prompts = [p if isinstance(p, tuple) else (p, max_new) for p in prompts]
    step = make_decode_fn(cfg)
    dev = params.device
    caches = T.init_decode_state(cfg, batch, cache_len, dev).caches
    positions = torch.zeros((batch,), dtype=torch.int32, device=dev)
    tokens = torch.zeros((batch, 1), dtype=torch.int32, device=dev)

    waiting = list(enumerate(prompts))
    slots = [SlotState() for _ in range(batch)]
    done: dict[int, list[int]] = {}
    t0 = time.perf_counter()
    steps = 0
    limits = [max_new] * batch

    def refill(slot_idx):
        rid, (first_tok, limit) = waiting.pop(0)
        slots[slot_idx].request_id = rid
        slots[slot_idx].generated = []
        limits[slot_idx] = limit
        _reset_slot(caches, slot_idx)
        positions[slot_idx] = 0
        tokens[slot_idx] = first_tok

    for i in range(batch):               # initial fill
        if waiting:
            refill(i)

    while any(s.request_id is not None for s in slots):
        tokens, caches = step(params, tokens, caches, positions)
        positions = positions + 1
        steps += 1
        toks_host = tokens[:, 0].cpu().numpy()
        for i, s in enumerate(slots):
            if s.request_id is None:
                continue
            s.generated.append(int(toks_host[i]))
            finished = (len(s.generated) >= limits[i]
                        or (eos is not None and s.generated[-1] == eos)
                        or int(positions[i]) >= cache_len - 1)
            if finished:
                done[s.request_id] = s.generated
                s.request_id = None
                if waiting:
                    refill(i)
    dt = time.perf_counter() - t0
    if verbose:
        total = sum(len(v) for v in done.values())
        print(f"served {len(done)} requests, {total} tokens in {dt:.2f}s "
              f"({total / dt:.0f} tok/s, {steps} batch steps; "
              f"static batching would need "
              f"{-(-len(done) // batch) * max_new} steps, ran {steps})")
    return done


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="deepseek-7b", choices=configs.ARCHS,
                    help="a dense (qwen1.5-4b, deepseek-7b, starcoder2-15b, "
                    "granite-3-2b), MoE (kimi-k2-1t-a32b, deepseek-v3-671b"
                    "), SSM (mamba2-1.3b) or hybrid (zamba2-7b) "
                    "architecture, at its smoke size; whisper-small and "
                    "llama-3.2-vision-11b are refused (their steps need "
                    "enc_out or patches: launch.steps.make_serve_step)")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; default the CUDA card")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get_smoke_config(args.arch)
    params = T.init_params(args.seed, cfg, device)
    rng = np.random.default_rng(args.seed)
    toks = rng.integers(0, cfg.vocab, size=args.requests)
    lens = rng.integers(max(2, args.max_new // 4), args.max_new + 1,
                        size=args.requests)
    # variable-length requests exercise the continuous refill
    prompts = [(int(t), int(n)) for t, n in zip(toks, lens)]
    done = serve(cfg, params, prompts, args.batch, args.max_new,
                 args.cache_len, eos=0)
    lens = sorted(len(v) for v in done.values())
    print(f"request lengths: min {lens[0]} max {lens[-1]} "
          f"(EOS=0 ends a request early)")


if __name__ == "__main__":
    main()
