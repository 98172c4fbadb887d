"""The HTTP gateway: `SamplingService` behind a stdlib front door (the
JAX package's ``repro.serve.gateway``: the same routes, body schema,
stream frames and semantics).

``ThreadingHTTPServer`` + ``BaseHTTPRequestHandler`` — no third-party web
stack; one OS thread per in-flight request, which is the right shape here
because a streaming response spends its life blocked on a condition
variable, not computing.

Routes (JSON in/out unless noted)::

    POST   /v1/jobs              submit → {"id", "cache", "state", ...}
    GET    /v1/jobs/<id>         status/progress snapshot
    GET    /v1/jobs/<id>/stream  chunked stream of sample blocks (frames)
    DELETE /v1/jobs/<id>         cancel the underlying execution
    GET    /v1/stats             service + cache + tenant snapshot
    GET    /metrics              Prometheus text exposition (repro_torch.obs)

**Authorization**: every ``/v1/jobs/<id>`` route resolves ``x-api-key``
exactly like submit does (401 on an unknown key) and answers 404 unless
the job belongs to the caller's tenant — a job id is never a capability,
and ids are unguessable tokens (``secrets.token_hex``) as defense in
depth.  The open (no tenants file) table maps every caller to the same
``anonymous`` tenant, so single-user deployments see no auth at all.

**Submission body** — a whitelist, unknown fields are a 400 (a typo'd
tuning knob must fail loudly, not silently sample with defaults)::

    {"store": "demo_chain",             # required (see store_root below)
     "n_samples": 4096,                 # required
     "seed": 7,                         # required (job key = prng.key(seed))
     "macro_batches": 4,                # optional, default 1
     "config": {"segment_len": 4, ...}} # optional SamplerConfig overrides

With ``store_root`` configured (``--store-root``), ``store`` is a
relative name resolved strictly beneath that directory — absolute paths
and ``..`` escapes are a 400, so clients can never point the server at
arbitrary host filesystem.  Without a root (trusted single-user mode)
``store`` is a server-side path, as before.

``config`` keys are validated against the full ``SamplerConfig`` schema
via the v2 wire codec (the port's ``remote.config_to_dict`` round-trip),
minus the server-side fields (``runtime``, ``hardware``, checkpoint
paths).  The resolved config's digest is part of the result cache's key;
it holds the port's kernel mode names and its ``Hardware`` (an H100), so
a cache directory is not shared with the JAX package's gateway.

**The stream wire format** is the transport's frame codec
(``runtime/transport.py``) inside a chunked HTTP body: per block a JSON
frame ``{"kind": "block", "batch_id": b, "nbytes": n}`` then an npy frame
of the (per_batch, M) int64 samples; terminated by ``{"kind": "end",
...}`` or ``{"kind": "error", "error": msg}``.  Frames come from the
result cache's entries, so a cache
hit re-serves byte-identical frames and an attached request streams the
owner's frames as they land (one execution, N streams).

**Cancel semantics**: an execution is shared by every request attached to
its cache entry, so only the *owning* request's DELETE cancels it (every
attached stream then sees the error frame — their results were the
owner's bytes).  An attacher's DELETE merely detaches its own record; a
hit-served request has nothing to cancel.
"""
from __future__ import annotations

import dataclasses
import json
import os
import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.runtime.transport import (array_to_frame, write_frame,
                                           write_json)
from repro_torch.serve.cache import ResultCache, cache_key
from repro_torch.serve.tenancy import (QuotaExceeded, TenantTable,
                                       UnknownTenant)

# request fields a client may set; everything else is the server's
_TOP_FIELDS = {"store", "n_samples", "seed", "macro_batches", "config"}
_REQUIRED = {"store", "n_samples", "seed"}
_SERVER_CONFIG_FIELDS = {"runtime", "hardware", "store_root",
                         "checkpoint_dir", "checkpoint_every"}
_SAMPLE_ITEMSIZE = 4               # the quota's bytes per sample and site


class _HTTPError(Exception):
    def __init__(self, code: int, msg: str, **extra):
        super().__init__(msg)
        self.code = code
        self.body = dict({"error": msg}, **extra)
        self.headers: dict[str, str] = {}


@dataclasses.dataclass
class _Record:
    """One submitted request's view of its (possibly shared) execution."""
    gid: str
    tenant_name: str
    cache_status: str              # hit | attach | miss
    entry: object                  # serve.cache.Entry
    handle: object                 # api.service.JobHandle (miss only)
    n_samples: int
    n_batches: int
    created: float
    cancelled: bool = False

    def state(self) -> str:
        if self.handle is not None:
            return self.handle.status()
        if self.cancelled:
            return "cancelled"
        return self.entry.state       # running | done | failed

    def snapshot(self) -> dict:
        out = {"id": self.gid, "tenant": self.tenant_name,
               "cache": self.cache_status, "state": self.state(),
               "n_samples": self.n_samples, "n_batches": self.n_batches,
               "blocks_done": len(self.entry.blocks),
               "created": self.created}
        if self.entry.error:
            out["error"] = self.entry.error
        if self.handle is not None:
            out["progress"] = {
                k: v for k, v in self.handle.progress.items()
                if isinstance(v, (int, float, bool, str))}
            report = self.handle.fault_report()
            if report is not None:
                # the structured failure surface: fault taxonomy records +
                # the dead-letter when bounded retries gave the job up
                out["fault_report"] = report
        return out


class Gateway:
    """The server object: owns the HTTP listener, the request records, and
    the (tenants, cache, registry) collaborators; drives — but does not
    own — the :class:`~repro_torch.api.service.SamplingService`."""

    def __init__(self, service, *, tenants: Optional[TenantTable] = None,
                 cache: Optional[ResultCache] = None, registry=None,
                 host: str = "127.0.0.1", port: int = 0,
                 store_root: Optional[str] = None, max_records: int = 4096):
        self.service = service
        self.tenants = tenants or TenantTable()
        self.cache = cache or ResultCache()
        self.registry = registry
        self.store_root = store_root
        self.max_records = max_records
        self._host, self._port = host, port
        self._lock = threading.Lock()
        self._records: dict[str, _Record] = {}
        self._digest_cache: dict[str, tuple[tuple, str, int]] = {}
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.requests = 0
        if registry is not None:
            self._wire_metrics(registry)
        else:
            self._http_requests = None

    # -- telemetry -----------------------------------------------------------
    def _wire_metrics(self, registry, prefix: str = "fastmps") -> None:
        self._http_requests = registry.counter(
            f"{prefix}_http_requests_total", "HTTP requests by route/code",
            labelnames=("route", "code"))
        cache_events = registry.counter(
            f"{prefix}_cache_events_total",
            "Result-cache events (hit/miss/attach/evict)",
            labelnames=("event",))
        self.cache.observer = lambda event, **f: cache_events.labels(
            event=event.removeprefix("cache_")).inc()
        self._tenant_rejections = registry.counter(
            f"{prefix}_tenant_rejections_total",
            "Requests rejected by tenant quota (HTTP 429)")
        g_disk = registry.gauge(f"{prefix}_cache_disk_bytes",
                                "Result-cache on-disk footprint")
        g_entries = registry.gauge(f"{prefix}_cache_entries",
                                   "Result-cache in-memory entries")
        g_active = registry.gauge(f"{prefix}_tenant_active_jobs",
                                  "Executing jobs across tenants")
        g_corrupt = registry.gauge(f"{prefix}_cache_corrupt_entries",
                                   "Corrupt result-cache disk entries "
                                   "dropped (disk rot / torn writes)")

        def collect() -> None:
            cs = self.cache.stats()
            g_disk.set(cs["disk_bytes"])
            g_entries.set(cs["entries"])
            g_active.set(self.tenants.stats()["active_jobs"])
            g_corrupt.set(cs.get("corrupt_entries", 0))

        registry.add_collector(collect)

    def _observe_request(self, route: str, code: int) -> None:
        self.requests += 1
        if self._http_requests is not None:
            self._http_requests.labels(route=route, code=str(code)).inc()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "Gateway":
        gw = self

        class Handler(_Handler):
            gateway = gw

        self._server = ThreadingHTTPServer((self._host, self._port), Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="fastmps-gateway", daemon=True)
        self._thread.start()
        return self

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=30)
            self._server = None

    def __enter__(self) -> "Gateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- store identity ------------------------------------------------------
    def _resolve_store(self, name: str) -> str:
        """Client ``store`` field → server path.  With a configured
        ``store_root`` the name must resolve strictly beneath it (realpath
        containment, so ``..`` and symlink escapes both fail); without one
        (trusted single-user mode) the name is used as a path verbatim."""
        if self.store_root is None:
            return name
        if os.path.isabs(name):
            raise _HTTPError(
                400, f"store {name!r} must be a name relative to the "
                     f"configured store root, not an absolute path")
        if ".." in name.replace("\\", "/").split("/"):
            raise _HTTPError(400, f"store {name!r} escapes the store root")
        root = os.path.realpath(self.store_root)
        real = os.path.realpath(os.path.join(root, name))
        if real != root and not real.startswith(root + os.sep):
            raise _HTTPError(400, f"store {name!r} escapes the store root")
        return real

    def _store_identity(self, path: str) -> tuple[str, int]:
        """(content digest, n_sites) of the store at ``path``, cached per
        realpath and invalidated when any site file's (name, mtime_ns,
        size, inode) changes — submissions against an unchanged store
        don't re-hash.  ``st_mtime_ns + st_ino`` (not coarse mtime) so an
        atomic rewrite with identical size can't serve a stale digest."""
        real = os.path.realpath(path)
        if not os.path.isdir(real):
            raise _HTTPError(400, f"store {path!r} is not a directory")
        sites = sorted(f for f in os.listdir(real)
                       if f.startswith("site_") and f.endswith(".npz"))
        if not sites:
            raise _HTTPError(400, f"store {path!r} holds no site_*.npz")
        stats = [os.stat(os.path.join(real, f)) for f in sites]
        sig = tuple((f, st.st_mtime_ns, st.st_size, st.st_ino)
                    for f, st in zip(sites, stats))
        with self._lock:
            hit = self._digest_cache.get(real)
            if hit is not None and hit[0] == sig:
                return hit[1], hit[2]
        from repro_torch.data.gamma_store import GammaStore
        with GammaStore(real) as store:
            digest = store.digest()
        with self._lock:
            self._digest_cache[real] = (sig, digest, len(sites))
        return digest, len(sites)

    # -- submission ----------------------------------------------------------
    def _parse_body(self, body: dict):
        from repro_torch.api.config import SamplerConfig
        from repro_torch.api.remote import config_from_dict, config_to_dict

        if not isinstance(body, dict):
            raise _HTTPError(400, "request body must be a JSON object")
        unknown = set(body) - _TOP_FIELDS
        if unknown:
            raise _HTTPError(400, f"unknown fields {sorted(unknown)} "
                                  f"(accepted: {sorted(_TOP_FIELDS)})")
        missing = _REQUIRED - set(body)
        if missing:
            raise _HTTPError(400, f"missing required fields "
                                  f"{sorted(missing)}")
        try:
            n_samples = int(body["n_samples"])
            seed = int(body["seed"])
            macro_batches = int(body.get("macro_batches", 1))
        except (TypeError, ValueError):
            raise _HTTPError(400, "n_samples/seed/macro_batches must be "
                                  "integers")
        if n_samples < 1 or macro_batches < 1:
            raise _HTTPError(400, "n_samples and macro_batches must be ≥ 1")
        if n_samples % macro_batches:
            raise _HTTPError(400, f"n_samples={n_samples} must divide over "
                                  f"{macro_batches} macro batches")
        # the override schema is the SamplerConfig dataclass itself, so new
        # client-side fields (e.g. the workloads `clamp` spec, a {site:
        # outcome} object — conditional jobs) are accepted here without a
        # gateway change; a malformed value (clamp included) fails
        # SamplerConfig construction below → clean 400, and the resolved
        # digest folds it into the ResultCache key, so a clamped job can
        # never serve an unclamped job's cached frames (or vice versa)
        overrides = body.get("config") or {}
        if not isinstance(overrides, dict):
            raise _HTTPError(400, "config must be a JSON object")
        base = config_to_dict(SamplerConfig())
        for k in overrides:
            if k in _SERVER_CONFIG_FIELDS:
                raise _HTTPError(400, f"config field {k!r} is server-side")
            if k not in base:
                raise _HTTPError(400, f"unknown config field {k!r}")
        merged = dict(base, **overrides)
        try:
            cfg = config_from_dict(merged)
        except Exception as e:       # noqa: BLE001 — client error, not ours
            raise _HTTPError(400, f"invalid config: {e}")
        # the resolved-config digest: the cache key must see the config the
        # engine will actually consume, not the request's sparse overrides
        cfg_digest = json.dumps(config_to_dict(cfg), sort_keys=True,
                                default=str)
        return str(body["store"]), cfg, cfg_digest, n_samples, seed, \
            macro_batches

    def submit(self, body: dict, api_key: Optional[str]) -> dict:
        from repro_torch.core import prng

        try:
            tenant = self.tenants.resolve(api_key)
        except UnknownTenant as e:
            raise _HTTPError(401, str(e))
        store, cfg, cfg_digest, n_samples, seed, macro_batches = \
            self._parse_body(body)
        store = self._resolve_store(store)
        store_digest, n_sites = self._store_identity(store)
        nbytes = n_samples * n_sites * _SAMPLE_ITEMSIZE
        try:
            priority = self.tenants.begin_job(tenant, nbytes)
        except QuotaExceeded as e:
            if self.registry is not None:
                self._tenant_rejections.inc()
            err = _HTTPError(429, str(e),
                            admission=self.service.stats()["admission"])
            err.headers["Retry-After"] = str(max(1, int(e.retry_after_s)))
            raise err
        key = cache_key(store_digest, cfg_digest, seed, n_samples,
                        macro_batches)
        entry, status = self.cache.get_or_begin(key, macro_batches)
        gid = f"j{secrets.token_hex(12)}"     # unguessable: ids leak nothing
        handle = None
        if status == "miss":
            try:
                handle = self.service.submit(
                    store, cfg, n_samples=n_samples,
                    key=prng.key(seed), macro_batches=macro_batches,
                    priority=priority)
            except Exception as e:    # noqa: BLE001 — refuse, roll back
                entry.finish(error=str(e))
                self.cache.seal(entry)
                self.tenants.end_job(tenant, nbytes)
                raise _HTTPError(400, f"submit rejected: {e}")
            threading.Thread(target=self._pump,
                             args=(handle, entry, tenant, nbytes),
                             name=f"gateway-pump-{gid}", daemon=True).start()
        else:
            # hit/attach: this request triggers no execution — its quota
            # charge releases immediately (the owner's charge stands)
            self.tenants.end_job(tenant, nbytes)
        rec = _Record(gid=gid, tenant_name=tenant.name, cache_status=status,
                      entry=entry, handle=handle, n_samples=n_samples,
                      n_batches=macro_batches, created=time.time())
        with self._lock:
            self._records[gid] = rec
            self._purge_records_locked()
        return rec.snapshot()

    def _purge_records_locked(self) -> None:
        """Bound ``_records``: beyond ``max_records``, drop the oldest
        *terminal* (done/failed/cancelled) records — insertion order is
        creation order.  Live records are never dropped, so the table can
        exceed the bound only while that many jobs are actually in
        flight."""
        excess = len(self._records) - self.max_records
        if excess <= 0:
            return
        drop = []
        for gid, rec in self._records.items():
            if len(drop) >= excess:
                break
            if rec.state() in ("done", "failed", "cancelled"):
                drop.append(gid)
        for gid in drop:
            del self._records[gid]

    def _pump(self, handle, entry, tenant, nbytes: int) -> None:
        """Owner loop of a cache-miss execution: service blocks → cache
        frames.  Every attached stream reads the entry, never the handle."""
        try:
            for b, block in handle.stream():
                entry.publish(b, array_to_frame(block))
            entry.finish()
        except BaseException as e:    # noqa: BLE001 — surfaced as a frame
            entry.finish(error=f"{type(e).__name__}: {e}")
        finally:
            self.cache.seal(entry)
            self.tenants.end_job(tenant, nbytes)

    # -- the other routes ----------------------------------------------------
    def record(self, gid: str, api_key: Optional[str]) -> _Record:
        """gid → record, tenant-scoped: the caller's key must resolve
        (401) and the record must belong to that tenant — a foreign
        tenant's job id answers 404, indistinguishable from absent, so
        ids leak neither results nor existence."""
        try:
            tenant = self.tenants.resolve(api_key)
        except UnknownTenant as e:
            raise _HTTPError(401, str(e))
        with self._lock:
            rec = self._records.get(gid)
        if rec is None or rec.tenant_name != tenant.name:
            raise _HTTPError(404, f"no such job {gid!r}")
        return rec

    def cancel(self, gid: str, api_key: Optional[str]) -> dict:
        rec = self.record(gid, api_key)
        if rec.handle is not None:
            ok = rec.handle.cancel()
        else:
            ok = rec.entry.state == "running" and rec.cache_status == "attach"
            rec.cancelled = rec.cancelled or ok
        return {"id": gid, "cancelled": bool(ok), "state": rec.state()}

    def stats(self) -> dict:
        with self._lock:
            recs = list(self._records.values())
        by_state: dict[str, int] = {}
        for r in recs:
            s = r.state()
            by_state[s] = by_state.get(s, 0) + 1
        return {"service": self.service.stats(),
                "cache": self.cache.stats(),
                "tenants": self.tenants.stats(),
                "gateway": {"requests": self.requests,
                            "jobs": len(recs), "by_state": by_state}}


class _ChunkedWriter:
    """File-like adapter that chunk-encodes writes onto the raw socket —
    lets the transport's frame codec write straight into an HTTP/1.1
    chunked body."""

    def __init__(self, wfile):
        self._w = wfile

    def write(self, data: bytes) -> int:
        if data:
            self._w.write(b"%X\r\n" % len(data))
            self._w.write(data)
            self._w.write(b"\r\n")
        return len(data)

    def flush(self) -> None:
        self._w.flush()

    def close(self) -> None:
        self._w.write(b"0\r\n\r\n")
        self._w.flush()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # small JSON exchanges + length-prefixed frames are exactly the write
    # pattern Nagle+delayed-ACK stalls (~40ms per exchange on loopback)
    disable_nagle_algorithm = True
    gateway: Gateway = None        # bound by Gateway.start()

    # -- plumbing ------------------------------------------------------------
    def log_message(self, *args) -> None:     # noqa: D102 — silence stderr
        pass

    def _json(self, code: int, obj: dict,
              headers: Optional[dict] = None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _route(self, method: str) -> tuple[str, tuple]:
        parts = [p for p in self.path.split("?")[0].split("/") if p]
        if parts == ["metrics"] and method == "GET":
            return "metrics", ()
        if parts[:1] == ["v1"]:
            rest = parts[1:]
            if rest == ["stats"] and method == "GET":
                return "stats", ()
            if rest == ["jobs"] and method == "POST":
                return "submit", ()
            if len(rest) == 2 and rest[0] == "jobs":
                if method == "GET":
                    return "status", (rest[1],)
                if method == "DELETE":
                    return "cancel", (rest[1],)
            if (len(rest) == 3 and rest[0] == "jobs"
                    and rest[2] == "stream" and method == "GET"):
                return "stream", (rest[1],)
        raise _HTTPError(404, f"no route {method} {self.path}")

    def _dispatch(self, method: str) -> None:
        gw = self.gateway
        route = "?"
        try:
            route, args = self._route(method)
            code = getattr(self, "_do_" + route)(*args)
        except _HTTPError as e:
            code = e.code
            self._json(e.code, e.body, headers=e.headers)
        except (BrokenPipeError, ConnectionResetError):
            code = 499                      # client went away mid-stream
        except Exception as e:              # noqa: BLE001 — a 500, not a crash
            code = 500
            try:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            except OSError:
                pass
        gw._observe_request(route, code)

    def do_GET(self) -> None:
        self._dispatch("GET")

    def do_POST(self) -> None:
        self._dispatch("POST")

    def do_DELETE(self) -> None:
        self._dispatch("DELETE")

    # -- routes --------------------------------------------------------------
    def _do_submit(self) -> int:
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, TypeError):
            raise _HTTPError(400, "body is not valid JSON")
        out = self.gateway.submit(body, self._api_key())
        self._json(201, out)
        return 201

    def _api_key(self) -> Optional[str]:
        return self.headers.get("x-api-key")

    def _do_status(self, gid: str) -> int:
        self._json(200, self.gateway.record(gid, self._api_key()).snapshot())
        return 200

    def _do_cancel(self, gid: str) -> int:
        self._json(200, self.gateway.cancel(gid, self._api_key()))
        return 200

    def _do_stream(self, gid: str) -> int:
        rec = self.gateway.record(gid, self._api_key())
        self.send_response(200)
        self.send_header("Content-Type", "application/x-fastmps-frames")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        w = _ChunkedWriter(self.wfile)
        try:
            for b, frame in rec.entry.stream():
                write_json(w, {"kind": "block", "batch_id": b,
                               "nbytes": len(frame)})
                write_frame(w, frame)
            write_json(w, {"kind": "end", "n_batches": rec.n_batches})
        except (TimeoutError, RuntimeError) as e:
            write_json(w, {"kind": "error", "error": str(e)})
        w.close()          # chunked terminator — the connection stays usable
        return 200

    def _do_stats(self) -> int:
        self._json(200, self.gateway.stats())
        return 200

    def _do_metrics(self) -> int:
        if self.gateway.registry is None:
            raise _HTTPError(404, "no metrics registry configured")
        body = self.gateway.registry.render().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return 200


__all__ = ["Gateway"]
