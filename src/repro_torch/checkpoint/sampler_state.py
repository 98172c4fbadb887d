"""Mid-chain sampler checkpoints (paper §4.1 seed consistency).

The unit of restart is (site index, left environment, PRNG key, samples so
far).  Every draw after ``site`` depends only on the carried key, so a
resumed walk emits the uninterrupted one's samples bit for bit.

The file layout is the JAX package's (``repro.checkpoint.sampler_state``):
``site_XXXXXX.npz`` with ``env``, ``key``, ``log_scale``, ``samples``,
``site`` and a ``sha256`` of the payload.  ``key`` holds the threefry key's
two words as uint32 — what ``jax.random.key_data`` gives — so a checkpoint
either package wrote loads in the other.
"""
from __future__ import annotations

import hashlib
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core.sampler import SamplerState
from repro_torch.device import DeviceLike
from repro_torch.runtime.faults import CorruptSegment, Fault


def _state_digest(env, key, log_scale, samples) -> str:
    """sha256 over the checkpoint's payload (dtype, shape and bytes of
    each array) — stored at save, checked at load."""
    h = hashlib.sha256()
    for a in (env, key, log_scale, samples):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _sites(root: str) -> list[str]:
    return sorted(f for f in os.listdir(root)
                  if f.startswith("site_") and f.endswith(".npz"))


def save_sampler_state(root: str, site: int, state: SamplerState,
                       samples_so_far: np.ndarray, keep: int = 3) -> str:
    """Atomic, fsync'd checkpoint of the walk at ``site``; keeps the
    ``keep`` newest (0 keeps all)."""
    os.makedirs(root, exist_ok=True)
    # the temp name must not match site_*.npz: a kill between the write and
    # the rename would leave a torn file that the loader could pick
    tmp = os.path.join(root, f".tmp_site_{site:06d}.npz")
    final = os.path.join(root, f"site_{site:06d}.npz")
    env = state.env.detach().cpu().numpy()
    key = state.key.cpu().numpy().astype(np.uint32)
    log_scale = state.log_scale.detach().cpu().numpy()
    samples = np.asarray(samples_so_far)
    digest = _state_digest(env, key, log_scale, samples)
    with open(tmp, "wb") as f:
        np.savez(f, env=env, key=key, log_scale=log_scale, samples=samples,
                 site=site,
                 sha256=np.frombuffer(digest.encode(), dtype=np.uint8))
        f.flush()
        os.fsync(f.fileno())       # the bytes are durable before the rename
    os.replace(tmp, final)
    dfd = os.open(root, os.O_RDONLY)
    try:
        os.fsync(dfd)              # and so is the rename
    finally:
        os.close(dfd)
    if keep:
        for f in _sites(root)[:-keep]:
            os.remove(os.path.join(root, f))
    return final


def newest_checkpoint_site(root: str) -> int:
    """Site of the newest checkpoint under ``root``; 0 when there is none
    (resuming from site 0 recomputes everything, which is always safe)."""
    if not os.path.isdir(root):
        return 0
    files = _sites(root)
    if not files:
        return 0
    return int(files[-1].split("_")[1].split(".")[0])


def load_sampler_state(root: str, site: Optional[int] = None,
                       device: DeviceLike = "cpu"
                       ) -> tuple[int, SamplerState, np.ndarray]:
    """(site, state with tensors on ``device``, samples) of the newest
    checkpoint, or of ``site``; a payload that fails its digest raises
    :class:`CorruptSegment`."""
    files = _sites(root)
    if not files:
        raise FileNotFoundError(root)
    if site is None:
        fn = files[-1]
    else:
        fn = f"site_{site:06d}.npz"
    with np.load(os.path.join(root, fn)) as z:
        env, key, log_scale = z["env"], z["key"], z["log_scale"]
        samples = z["samples"]
        if "sha256" in z.files:    # absent in checkpoints older than it
            want = bytes(z["sha256"]).decode()
            got = _state_digest(env, key, log_scale, samples)
            if got != want:
                raise CorruptSegment(Fault(
                    kind="corruption", site=int(z["site"]), store=root,
                    message=f"sampler checkpoint {fn} digest mismatch "
                            f"(embedded {want[:12]}…, recomputed "
                            f"{got[:12]}…) — refusing to resume from "
                            f"rotted state"))
        state = SamplerState(
            torch.from_numpy(env).to(device),
            torch.from_numpy(key.astype(np.int64)),
            torch.from_numpy(log_scale).to(device))
        return int(z["site"]), state, samples
