"""Remote dispatch: serialize a `SamplerConfig`, ship it through a runtime.

The ``remote`` data plane does not walk the chain itself: it packs the
request (config, store location, batch size, PRNG key and the job batch)
into a JSON *payload* and hands it to
:meth:`repro_torch.api.runtime.ClusterRuntime.submit`:

* :class:`~repro_torch.api.runtime.LocalRuntime` runs the payload in this
  process (the loopback transport: the same serialization boundary, no
  worker);
* :class:`RemoteRuntime` (``runtime="remote"``) sends it to a **persistent
  worker process** over the framed-pipe RPC of
  ``repro_torch.runtime.transport``: spawned on the first submit, alive
  across submits (its sessions, engines and loaded kernels stay warm),
  reaped when the runtime closes.  ``persistent=False`` starts one
  ``python -m repro_torch.api.remote`` per submit instead.

The worker resolves the inner config on its own local runtime (``backend``
AUTO → streamed from the store path), so remote samples equal a local
streamed walk's for the same key.  The payload is the JAX package's v2
job-batch payload (``repro.api.remote``) field for field — dtypes by name,
the key as its two uint32 words — so a payload built by either package
runs in the other and gives the same samples.

A worker runs on the card unless it is started with ``--device cpu``
(``RemoteRuntime(device=...)``, ``WorkerPool(device=...)``); without a GPU
its first call fails with the error, it never walks on the CPU instead.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np
import torch

from repro_torch.api.runtime import (AUTO, ClusterRuntime, dtype_from_name,
                                     dtype_name, register_runtime)

_DTYPE_FIELDS = ("compute_dtype", "wire_dtype")
# the JAX package's kernel modes and the port's
_KERNELS_FROM_JAX = {"pallas": "cuda", "xla": "torch"}


def config_to_dict(config) -> dict:
    """``SamplerConfig`` → a JSON-serializable dict (dtypes by name, the
    ``Hardware`` by its fields, the runtime by name).  Field by field, not
    ``dataclasses.asdict``: the runtime may be a live instance."""
    out = {f.name: getattr(config, f.name)
           for f in dataclasses.fields(config)}
    for f in _DTYPE_FIELDS:
        out[f] = None if out[f] is None else dtype_name(out[f])
    rt = out.get("runtime")
    out["runtime"] = rt if isinstance(rt, (str, type(None))) else rt.name
    out["hardware"] = dataclasses.asdict(config.hardware)
    if out.get("chi_profile") is not None:
        out["chi_profile"] = [int(c) for c in out["chi_profile"]]
    if out.get("clamp") is not None:
        # the canonical pair list, as the JAX package writes it
        out["clamp"] = [[int(s), list(o) if isinstance(o, tuple) else int(o)]
                        for s, o in out["clamp"]]
    return out


def config_from_dict(d: dict):
    """Inverse of :func:`config_to_dict` (also reads the JAX package's:
    its kernel modes ``pallas``/``xla`` become ``cuda``/``torch``)."""
    from repro_torch.api.config import SamplerConfig
    from repro_torch.core.perfmodel import Hardware

    d = dict(d)
    for f in _DTYPE_FIELDS:
        d[f] = None if d.get(f) is None else dtype_from_name(d[f])
    d["hardware"] = Hardware(**d["hardware"])
    if d.get("chi_profile") is not None:
        d["chi_profile"] = tuple(int(c) for c in d["chi_profile"])
    d["kernels"] = _KERNELS_FROM_JAX.get(d.get("kernels"), d.get("kernels",
                                                                 AUTO))
    return SamplerConfig(**d)


def key_words(key: torch.Tensor) -> list[int]:
    """The two uint32 words of a key (``jax.random.key_data``'s)."""
    return [int(w) & 0xFFFFFFFF for w in key.tolist()]


def key_from_words(words) -> torch.Tensor:
    return torch.tensor([int(w) for w in words], dtype=torch.int64)


def build_payload(config, store, n_samples: int, key: torch.Tensor,
                  job=None) -> dict:
    """The unit of dispatch, one JOB BATCH as plain JSON: the session
    config, the store's location and dtypes, the batch size, the job's
    base key and (``job``, a ``service.JobBatch``) the batch's identity.
    The worker derives the batch key itself (``service.batch_key``), so a
    service may scatter a job's batches over many workers.  ``job=None``
    is the v1 whole-run payload (a one-batch job).  Γ never rides the
    payload; the store's location does."""
    inner = dataclasses.replace(config, backend=AUTO, runtime="local",
                                store_root=None, checkpoint_dir=None)
    out = {
        "version": 2,
        "config": config_to_dict(inner),
        "store_root": str(store.root),
        "storage_dtype": dtype_name(store.storage_dtype),
        "compute_dtype": dtype_name(store.compute_dtype),
        "n_samples": int(n_samples),
        "key_data": key_words(key),
        "enable_x64": True,           # a JAX worker walks fp64 stores in fp64
    }
    if job is not None:
        out["job"] = {"job_id": int(job.job_id),
                      "batch_id": int(job.batch_id),
                      "n_batches": int(job.n_batches)}
    return out


class _CachedSession:
    """A worker-held (store, session) pair, one per payload cell, kept
    open across batches so a job's batches reuse one engine."""

    def __init__(self, store, session):
        self.store = store
        self.session = session

    def close(self) -> None:
        self.session.close()
        self.store.close()


def payload_cell(payload: dict) -> tuple:
    """The worker-side session identity of a payload (the mirror of the
    service's (source, config) coalescing cell)."""
    return (payload["store_root"], payload["storage_dtype"],
            payload["compute_dtype"],
            json.dumps(payload["config"], sort_keys=True))


def _open(payload: dict, device):
    from repro_torch.api.session import SamplingSession
    from repro_torch.data.gamma_store import GammaStore

    store = GammaStore(payload["store_root"],
                       storage_dtype=dtype_from_name(payload["storage_dtype"]),
                       compute_dtype=dtype_from_name(payload["compute_dtype"]))
    try:
        return _CachedSession(store, SamplingSession(
            store, config_from_dict(payload["config"]), device=device))
    except BaseException:
        store.close()
        raise


def execute_payload_with_stats(payload: dict, cache: Optional[dict] = None,
                               device=None) -> tuple[np.ndarray, dict]:
    """Run one payload: ``(samples, the walk's stats)``.  ``cache`` (a dict
    the caller owns and closes) keeps sessions across batches; ``device``
    is where the walk runs (None: the card)."""
    from repro_torch.api.service import batch_key

    version = int(payload.get("version", 1))
    if version not in (1, 2):
        raise ValueError(f"unknown payload version {version}")
    key = key_from_words(payload["key_data"])
    job = payload.get("job")
    if job is not None:
        key = batch_key(key, int(job["batch_id"]), int(job["n_batches"]))
    if cache is None:
        entry = _open(payload, device)
        try:
            out = entry.session.sample(payload["n_samples"], key)
            return out, dict(entry.session.stats)
        finally:
            entry.close()
    tok = payload_cell(payload)
    entry = cache.get(tok)
    if entry is None:
        entry = cache[tok] = _open(payload, device)
    out = entry.session.sample(payload["n_samples"], key)
    return out, dict(entry.session.stats)


def execute_payload(payload: dict, cache: Optional[dict] = None,
                    device=None) -> np.ndarray:
    """Run one payload to completion — the worker half of the dispatch:
    in this process for ``LocalRuntime.submit``, as ``__main__`` for the
    one-shot worker, per batch frame in the persistent worker.  v1 and v2
    payloads; a v2 payload's ``job`` selects the batch key as the local
    scheduler does."""
    return execute_payload_with_stats(payload, cache, device)[0]


@register_runtime("remote")
class RemoteRuntime(ClusterRuntime):
    """Dispatch payloads to worker processes on this machine.

    ``persistent=True``: one long-lived worker (``repro_torch.runtime.
    transport``) spawned on the first :meth:`submit` and kept across
    submits; a worker that died is respawned on the next submit, and the
    failed submit raises ``transport.TransportError`` so the caller
    requeues the (idempotent) batch.  ``persistent=False``: a fresh
    ``python -m repro_torch.api.remote`` per submit, the measurable
    baseline.  ``device`` is where the worker walks; None takes the
    submitting session's."""
    name = "remote"

    def __init__(self, python: Optional[str] = None,
                 env: Optional[dict] = None, timeout: float = 600.0,
                 persistent: bool = True, device=None):
        self.python = python or sys.executable
        self.env = env
        self.timeout = timeout
        self.persistent = persistent
        self.device = device
        self._worker = None
        self._dispatch_bytes = 0
        self._dispatches = 0

    def io_counters(self) -> dict:
        out = super().io_counters()
        out.update(dispatch_bytes=self._dispatch_bytes,
                   dispatches=self._dispatches,
                   persistent_worker=bool(self._worker is not None
                                          and self._worker.alive))
        return out

    @property
    def worker(self):
        """The persistent worker process, or None before the first
        submit."""
        return self._worker

    def submit(self, payload: dict, device=None) -> np.ndarray:
        blob = json.dumps(payload).encode()
        self._dispatch_bytes += len(blob)
        self._dispatches += 1
        dev = self.device if self.device is not None else device
        dev = None if dev is None else str(dev)
        if not self.persistent:
            return self._submit_oneshot(blob, dev)
        from repro_torch.runtime.transport import WorkerProcess
        if self._worker is None or not self._worker.alive:
            self._worker = WorkerProcess("remote-0", python=self.python,
                                         env=self.env, timeout=self.timeout,
                                         device=dev)
        return self._worker.call(payload)

    def close(self) -> None:
        if self._worker is not None:
            self._worker.close()
            self._worker = None

    def _submit_oneshot(self, blob: bytes, device) -> np.ndarray:
        """A fresh interpreter per batch, serially."""
        from repro_torch.runtime.transport import worker_env
        with tempfile.TemporaryDirectory(prefix="fastmps_remote_") as tmp:
            payload_path = os.path.join(tmp, "payload.json")
            out_path = os.path.join(tmp, "samples.npy")
            with open(payload_path, "wb") as f:
                f.write(blob)
            cmd = [self.python, "-m", "repro_torch.api.remote", payload_path,
                   out_path] + ([] if device is None else ["--device",
                                                           device])
            proc = subprocess.run(cmd, env=worker_env(self.env),
                                  capture_output=True, text=True,
                                  timeout=self.timeout)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"remote worker failed (rc={proc.returncode}):\n"
                    f"{proc.stderr[-2000:]}")
            return np.load(out_path)


def _worker_main(argv: list[str]) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one sampling payload.")
    ap.add_argument("payload")
    ap.add_argument("out")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    with open(args.payload) as f:
        payload = json.load(f)
    np.save(args.out, execute_payload(payload, device=args.device))
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main(sys.argv[1:]))
