"""Content-addressed result cache over idempotent sampling jobs (a copy
of the JAX package's ``repro.serve.cache``, over the port's transport).

The cache key is the *full causal input* of a job's bytes: the GammaStore
content digest, the resolved-config digest, the integer seed, and the
(n_samples, macro_batches) split — everything :func:`repro_torch.api.
service.batch_key` and the engine consume.  Two requests with equal keys therefore
produce bit-identical blocks, which is what makes the three outcomes safe:

* **hit** — the blocks are already cached (memory or the on-disk store):
  serve the exact bytes, no compute;
* **attach** — an identical job is *running right now*: the second caller
  streams from the first job's entry as its blocks land (in-flight dedup —
  one execution, N streams);
* **miss** — the caller becomes the entry's owner: it runs the job,
  :meth:`Entry.publish`\\ es each block, and :meth:`Entry.finish`\\ es.

Blocks are stored as the npy frame bytes of the transport codec
(``runtime/transport.array_to_frame``) — the same bytes the gateway puts
on the wire, so a cache hit is bit-identical to the original stream by
construction, not by re-serialization.

The optional disk store persists finished entries under
``cache_dir/<key>/batch_*.npy`` (+ ``meta.json``) with an LRU byte budget:
when ``max_bytes`` would be exceeded, least-recently-used entries are
evicted whole.  Memory holds only running entries plus at most
``max_memory_entries`` finished ones (its own LRU, enforced at seal/load
time): an evicted finished entry re-serves from disk when a store is
configured, or becomes a miss in memory-only mode — either way a
long-running cache cannot accumulate every unique job's bytes.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
from typing import Iterator, Optional

from repro_torch.runtime.transport import array_from_frame

RUNNING, DONE_, FAILED_ = "running", "done", "failed"


def cache_key(store_digest: str, config_digest: str, seed: int,
              n_samples: int, macro_batches: int) -> str:
    """The content address of one job's result bytes (sha256 hex).

    ``macro_batches`` is part of the key even though the *concatenation*
    is seed-stable only per split — a k-batch job's blocks are framed
    per batch, and batch b draws with ``fold_in(key, b)`` (k > 1) vs the
    raw key (k == 1), so different splits are different byte streams."""
    return hashlib.sha256(json.dumps(
        {"store": store_digest, "config": config_digest, "seed": int(seed),
         "n_samples": int(n_samples), "macro_batches": int(macro_batches)},
        sort_keys=True).encode()).hexdigest()


class Entry:
    """One cached (or in-flight) job result: batch_id → npy frame bytes.

    The owner (the cache-miss caller) publishes blocks and finishes; any
    number of readers stream concurrently — :meth:`stream` blocks on a
    condition until the next expected batch lands, exactly the semantics
    of ``JobHandle.stream`` but over serialized bytes."""

    def __init__(self, key: str, n_batches: int):
        self.key = key
        self.n_batches = n_batches
        self.state = RUNNING
        self.error: Optional[str] = None
        self.blocks: dict[int, bytes] = {}
        self.created = time.time()
        self.last_used = time.monotonic()   # memory-LRU recency
        self._cond = threading.Condition()

    def publish(self, batch_id: int, frame: bytes) -> None:
        with self._cond:
            self.blocks[batch_id] = frame
            self._cond.notify_all()

    def finish(self, error: Optional[str] = None) -> None:
        with self._cond:
            self.state = FAILED_ if error else DONE_
            self.error = error
            self._cond.notify_all()

    @property
    def nbytes(self) -> int:
        with self._cond:
            return sum(len(b) for b in self.blocks.values())

    def stream(self, timeout: Optional[float] = None
               ) -> Iterator[tuple[int, bytes]]:
        """Yield ``(batch_id, npy_frame_bytes)`` in batch order as blocks
        land; raises RuntimeError if the owning job failed mid-stream."""
        for b in range(self.n_batches):
            deadline = None if timeout is None else time.monotonic() + timeout
            with self._cond:
                while b not in self.blocks:
                    if self.state == FAILED_:
                        raise RuntimeError(self.error or "job failed")
                    remaining = (None if deadline is None
                                 else deadline - time.monotonic())
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"cache entry {self.key[:12]}: batch {b} not "
                            f"published within {timeout}s")
                    self._cond.wait(timeout=remaining)
                frame = self.blocks[b]
            yield b, frame

    def result_arrays(self, timeout: Optional[float] = None) -> list:
        return [array_from_frame(f) for _, f in self.stream(timeout=timeout)]


class ResultCache:
    """In-memory entry table + optional LRU-bounded disk store.

    ``get_or_begin`` is the single entry point; its status return drives
    the gateway's hit / attach / miss paths.  ``stats()`` has a stable
    schema (hits/misses/attaches/evictions/corrupt_entries/entries/
    disk_entries/disk_bytes, always present)."""

    def __init__(self, cache_dir: Optional[str] = None,
                 max_bytes: Optional[int] = None,
                 max_memory_entries: int = 64):
        self.cache_dir = cache_dir
        self.max_bytes = max_bytes
        self.max_memory_entries = max_memory_entries
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._entries: dict[str, Entry] = {}
        self.hits = 0
        self.misses = 0
        self.attaches = 0
        self.evictions = 0
        self.corrupt_entries = 0   # disk entries dropped as unreadable
        # the telemetry seam (repro_torch.obs): observer(event) for
        # "cache_hit" / "cache_miss" / "cache_attach" / "cache_evict" /
        # "cache_corrupt"
        self.observer = None

    def _emit(self, event: str, **fields) -> None:
        if self.observer is not None:
            try:
                self.observer(event, **fields)
            except Exception:              # noqa: BLE001 — telemetry seam
                pass

    # -- disk store ----------------------------------------------------------
    def _dir(self, key: str) -> str:
        return os.path.join(self.cache_dir, key)

    def _load_disk(self, key: str) -> Optional[Entry]:
        """Disk entry → a DONE memory entry (touches mtime for LRU)."""
        d = self._dir(key)
        meta_path = os.path.join(d, "meta.json")
        if not os.path.exists(meta_path):
            return None
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            entry = Entry(key, int(meta["n_batches"]))
            for b in range(entry.n_batches):
                with open(os.path.join(d, f"batch_{b:05d}.npy"), "rb") as f:
                    entry.blocks[b] = f.read()
            entry.finish()
            os.utime(d)                    # LRU recency = dir mtime
            return entry
        except (OSError, ValueError, KeyError) as e:
            # corrupt entry: drop it — but LOUDLY, not silently.  A cache
            # entry that stopped deserializing means disk rot or a torn
            # write; operators need the count (metrics) and the key (log),
            # and the request falls through to a clean recompute.
            self.corrupt_entries += 1      # caller holds self._lock
            self._emit("cache_corrupt", key=key)
            logging.getLogger(__name__).warning(
                "result cache: dropping corrupt disk entry %s (%s: %s)",
                key, type(e).__name__, e)
            shutil.rmtree(d, ignore_errors=True)
            return None

    def _store_disk(self, entry: Entry) -> None:
        d = self._dir(entry.key)
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        for b, frame in entry.blocks.items():
            with open(os.path.join(tmp, f"batch_{b:05d}.npy"), "wb") as f:
                f.write(frame)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"key": entry.key, "n_batches": entry.n_batches,
                       "created": entry.created}, f)
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
        self._evict()

    def _disk_entries(self) -> list[tuple[str, float, int]]:
        """(key, mtime, bytes) per finished disk entry, oldest first."""
        if not self.cache_dir:
            return []
        out = []
        for key in os.listdir(self.cache_dir):
            d = self._dir(key)
            if not os.path.isdir(d) or key.endswith(".tmp"):
                continue
            try:
                size = sum(os.path.getsize(os.path.join(d, f))
                           for f in os.listdir(d))
                mtime = os.path.getmtime(d)
            except OSError:
                continue       # rmtree'd by a concurrent _evict mid-scan
            out.append((key, mtime, size))
        out.sort(key=lambda t: t[1])
        return out

    def _evict(self) -> None:
        if self.max_bytes is None:
            return
        entries = self._disk_entries()
        total = sum(size for _, _, size in entries)
        for key, _, size in entries:
            if total <= self.max_bytes:
                break
            shutil.rmtree(self._dir(key), ignore_errors=True)
            total -= size
            self.evictions += 1
            self._emit("cache_evict")

    def _evict_memory_locked(self) -> None:
        """Bound the in-memory table (caller holds ``_lock``): beyond
        ``max_memory_entries`` finished entries, drop the least recently
        used.  RUNNING entries are exempt — dropping one would break the
        in-flight dedup contract.  Streams already attached to a dropped
        entry keep their own reference; only the table forgets it."""
        finished = [(e.last_used, k) for k, e in self._entries.items()
                    if e.state != RUNNING]
        excess = len(finished) - self.max_memory_entries
        if excess <= 0:
            return
        finished.sort()
        for _, key in finished[:excess]:
            del self._entries[key]

    # -- the one entry point -------------------------------------------------
    def get_or_begin(self, key: str, n_batches: int
                     ) -> tuple[Entry, str]:
        """Resolve ``key`` → ``(entry, status)`` with status one of:

        * ``"hit"`` — a finished entry (memory or disk); stream it.
        * ``"attach"`` — a RUNNING entry; stream it (in-flight dedup).
        * ``"miss"`` — a fresh RUNNING entry registered under the caller's
          ownership: the caller MUST run the job, ``publish`` each block
          and ``finish`` (or ``finish(error=...)``) — and then call
          :meth:`seal` to persist and release the running slot.
        """
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                if entry.state == DONE_:
                    entry.last_used = time.monotonic()
                    self.hits += 1
                    self._emit("cache_hit")
                    return entry, "hit"
                if entry.state == RUNNING:
                    self.attaches += 1
                    self._emit("cache_attach")
                    return entry, "attach"
                # FAILED entries don't poison the key: fall through to miss
            if self.cache_dir:
                disk = self._load_disk(key)
                if disk is not None:
                    self._entries[key] = disk
                    self._evict_memory_locked()
                    self.hits += 1
                    self._emit("cache_hit")
                    return disk, "hit"
            entry = Entry(key, n_batches)
            self._entries[key] = entry
            self.misses += 1
            self._emit("cache_miss")
            return entry, "miss"

    def seal(self, entry: Entry) -> None:
        """Owner's epilogue after ``finish()``: persist a DONE entry to the
        disk store (under the LRU budget) and re-bound the in-memory
        table; drop a FAILED entry from the table so the next identical
        request recomputes."""
        if entry.state == DONE_:
            if self.cache_dir:
                self._store_disk(entry)
            with self._lock:
                entry.last_used = time.monotonic()
                self._evict_memory_locked()
        else:
            with self._lock:
                if self._entries.get(entry.key) is entry:
                    del self._entries[entry.key]

    def stats(self) -> dict:
        disk = self._disk_entries()
        with self._lock:
            running = sum(e.state == RUNNING for e in self._entries.values())
            return {"hits": self.hits, "misses": self.misses,
                    "attaches": self.attaches, "evictions": self.evictions,
                    "corrupt_entries": self.corrupt_entries,
                    "entries": len(self._entries), "running": running,
                    "disk_entries": len(disk),
                    "disk_bytes": sum(s for _, _, s in disk),
                    "max_bytes": self.max_bytes}


__all__ = ["Entry", "ResultCache", "cache_key"]
