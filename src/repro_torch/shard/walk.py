"""Wire codecs for the sharded walk's two kinds of traffic.

The walk (``StreamingEngine._sample_sharded``) moves two kinds of payload
between hosts, each a dict of numpy arrays, so every ``ClusterRuntime``
transport (in-process queues, gloo's ``send``/``recv``) carries them as
they are:

* **env handoff** — at each ownership boundary the finishing owner ships
  ``(env (N, χ), log_scale (N,), the base key's data, boundary site)``
  (and ``log_prob`` on a clamped walk) to the next owner.  The key never
  advances along the chain (site i draws on ``fold_in(base, i)``), so it
  rides only as a check: a receiver whose base key differs is walking
  another job and fails rather than splice two batches.  It crosses as
  the JAX package's ``uint32[2]`` key data, so a handoff payload is the
  same bytes in both packages.
* **sample blocks** — after the walk each host's ``(L, N)`` blocks meet
  in one all-gather, so every process returns the same ``(N, M)`` batch.

The env and ``log_scale`` cross as raw host bytes, with no cast, and the
receiving owner runs the same ``fit_env`` → segment walk the unsharded
loop runs on the same array: a sharded walk is the unsharded walk, run on
rotating hosts.
"""
from __future__ import annotations

import numpy as np
import torch


def payload_nbytes(payload: dict) -> int:
    """Wire size of a dict-of-arrays payload (what the runtimes count)."""
    return sum(int(v.nbytes) for v in payload.values()
               if isinstance(v, np.ndarray))


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- env handoff -------------------------------------------------------------

def encode_handoff(env, log_scale, key, site: int, log_prob=None) -> dict:
    """``key`` is the port's key (two words as int64) or its uint32 data;
    ``log_prob`` rides only on clamped walks."""
    payload = {"env": _host(env), "log_scale": _host(log_scale),
               "key": _host(key).astype(np.uint32),
               "site": np.asarray(int(site), dtype=np.int64)}
    if log_prob is not None:
        payload["log_prob"] = _host(log_prob)
    return payload


def decode_handoff(payload: dict
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """→ (env, log_scale, base-key data (uint32[2]), boundary site)."""
    return (np.asarray(payload["env"]), np.asarray(payload["log_scale"]),
            np.asarray(payload["key"]), int(payload["site"]))


def decode_handoff_log_prob(payload: dict):
    """The clamped walk's carry, or None on an unclamped handoff."""
    lp = payload.get("log_prob")
    return None if lp is None else np.asarray(lp)


# -- sample-block gather ------------------------------------------------------

_BLK = "blk_"


def encode_blocks(blocks: dict[int, np.ndarray]) -> dict:
    """{start_site: (L, N) block} → a flat savez-able payload."""
    return {f"{_BLK}{start:06d}": np.asarray(blk)
            for start, blk in sorted(blocks.items())}


def decode_blocks(payload: dict) -> dict[int, np.ndarray]:
    out = {}
    for k, v in payload.items():
        if k.startswith(_BLK):
            out[int(k[len(_BLK):])] = np.asarray(v)
    return out


def assemble_blocks(merged: dict[int, np.ndarray], n_sites: int,
                    n_samples: int) -> np.ndarray:
    """Gathered {start: (L, N)} blocks → the walk's (N, M) int64 output
    (the port's engine's dtype).  The blocks must tile [0, n_sites)
    exactly: a hole means an owner's blocks never arrived, and a short
    batch would corrupt what is computed from it."""
    out, cursor = [], 0
    for start in sorted(merged):
        blk = merged[start]
        if start != cursor:
            raise RuntimeError(
                f"sharded gather hole: sites [{cursor}, {start}) missing "
                f"(an owner's sample blocks never arrived)")
        if blk.shape[1] != n_samples:
            raise RuntimeError(
                f"sharded gather block at site {start} carries "
                f"{blk.shape[1]} samples, expected {n_samples}")
        out.append(blk)
        cursor += blk.shape[0]
    if cursor != n_sites:
        raise RuntimeError(f"sharded gather covers [0, {cursor}) of "
                           f"[0, {n_sites})")
    return np.concatenate(out, axis=0).T.astype(np.int64)


__all__ = ["assemble_blocks", "decode_blocks", "decode_handoff",
           "decode_handoff_log_prob", "encode_blocks", "encode_handoff",
           "payload_nbytes"]
