"""Synthetic LM data: deterministic, shardable, restart-exact.

A batch is a function of (seed, step) alone, so any worker can make any
batch again, and a resumed run reads the stream an uninterrupted run
would have read.  The draw is the reference's, bit for bit
(``core.prng.randint`` on ``fold_in(key(seed), step)``).
"""
from __future__ import annotations

from repro_torch.core import prng


def synthetic_token_stream(seed: int, vocab: int, batch: int, seq: int,
                           device=None):
    """Returns batch_at(step) → {"tokens" (B, S), "labels" (B, S)}, int64
    on ``device`` (the CPU by default), labels the tokens shifted by one:
    one (B, S + 1) int32 draw in [0, vocab)."""
    def batch_at(step: int):
        key = prng.fold_in(prng.key(seed), step)
        toks = prng.randint(key, (batch, seq + 1), 0, vocab,
                            device).long()
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return batch_at
