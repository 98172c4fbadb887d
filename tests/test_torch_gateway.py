"""The port's serving stack (``repro_torch.serve``: the gateway, the result
cache and the tenant table; ``repro_torch.launch.gateway``) over a real
socket, the counterparts of ``tests/test_gateway.py``'s cases, on the CPU.

Every test talks to a live ``ThreadingHTTPServer`` through
``http.client``.  The claims are wire-level: streamed frames equal the
in-process service's, bit for bit; quotas answer 429 with Retry-After;
one execution per content address however many requests ask; job routes
are tenant-scoped; a Prometheus scrape shows it all.  Against the JAX
package: its gateway, on the same store and request, serves the same
samples (each package's own frames: the port's blocks are int64), and its
cache, tenant table and cache key behave as the port's.  The launcher is
run with ``--device cpu --port 0 --serve-s`` and serves one request.
"""
import http.client
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api.service import SamplingService as JService  # noqa: E402
from repro.data.gamma_store import GammaStore as JStore  # noqa: E402
from repro.serve import Gateway as JGateway  # noqa: E402
from repro.serve import ResultCache as JCache  # noqa: E402
from repro.serve import cache_key as j_cache_key  # noqa: E402
from repro.serve.tenancy import TenantTable as JTable  # noqa: E402
from repro_torch.api.service import SamplingService  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.obs import MetricsRegistry, instrument_service  # noqa: E402
from repro_torch.runtime import transport  # noqa: E402
from repro_torch.serve import (Gateway, QuotaExceeded,  # noqa: E402
                               ResultCache, Tenant, TenantTable, cache_key)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chain(tmp_path_factory, linear_mps_10x6):
    root = str(tmp_path_factory.mktemp("gw_gamma"))
    with JStore(root, storage_dtype=jnp.float64,
                compute_dtype=jnp.float64) as store:
        store.write_mps(linear_mps_10x6)
    return root


def _service(**kw):
    return SamplingService(device="cpu", **kw)


# ---------------------------------------------------------------------------
# a minimal real-socket client
# ---------------------------------------------------------------------------

class _Exact:
    """Exact reads over a chunked response (``read(n)`` may come short
    across chunk boundaries; the frame codec needs exact reads)."""

    def __init__(self, resp):
        self.resp = resp

    def read(self, n):
        out = b""
        while len(out) < n:
            chunk = self.resp.read(n - len(out))
            if not chunk:
                break
            out += chunk
        return out


class Client:
    def __init__(self, url, api_key=None):
        host, port = url.removeprefix("http://").split(":")
        self.conn = http.client.HTTPConnection(host, int(port))
        self.api_key = api_key

    def _headers(self):
        return {"x-api-key": self.api_key} if self.api_key else {}

    def request(self, method, path, body=None):
        self.conn.request(method, path,
                          None if body is None else json.dumps(body),
                          self._headers())
        resp = self.conn.getresponse()
        return resp.status, dict(resp.getheaders()), \
            json.loads(resp.read() or b"{}")

    def submit(self, store, n_samples, seed, macro_batches=1, config=None,
               **extra):
        body = {"store": store, "n_samples": n_samples, "seed": seed,
                "macro_batches": macro_batches, **extra}
        if config is not None:
            body["config"] = config
        return self.request("POST", "/v1/jobs", body)

    def stream_frames(self, gid):
        """[(batch_id, npy frame bytes), ...] and the terminal header."""
        self.conn.request("GET", f"/v1/jobs/{gid}/stream", None,
                          self._headers())
        resp = self.conn.getresponse()
        assert resp.status == 200
        rx = _Exact(resp)
        frames, terminal = [], None
        while terminal is None:
            head = json.loads(transport.read_frame(rx))
            if head["kind"] == "block":
                frames.append((head["batch_id"], transport.read_frame(rx)))
            else:
                terminal = head
        resp.read()
        return frames, terminal

    def stream_samples(self, gid):
        frames, terminal = self.stream_frames(gid)
        assert terminal["kind"] == "end", terminal
        return np.concatenate(
            [transport.array_from_frame(f) for _, f in frames], axis=0)

    def close(self):
        self.conn.close()


def _inprocess_frames(root, n_samples, seed, macro_batches):
    """What the gateway must put on the wire: the in-process service's
    blocks through the same frame codec."""
    with _service(workers=1) as svc:
        h = svc.submit(root, n_samples=n_samples, key=prng.key(seed),
                       macro_batches=macro_batches)
        return [(b, transport.array_to_frame(blk))
                for b, blk in h.stream(timeout=300)]


def _samples(frames):
    return np.concatenate([transport.array_from_frame(f) for _, f in frames],
                          axis=0)


# ---------------------------------------------------------------------------
# submit / stream / status / cancel / validation
# ---------------------------------------------------------------------------

def test_submit_stream_status_and_validation(chain):
    with _service(workers=2) as svc, Gateway(svc) as gw:
        c = Client(gw.url)
        code, _, sub = c.submit(chain, 16, seed=3, macro_batches=4)
        assert code == 201 and sub["cache"] == "miss"
        samples = c.stream_samples(sub["id"])
        assert np.array_equal(samples,
                              _samples(_inprocess_frames(chain, 16, 3, 4)))
        code, _, st = c.request("GET", f"/v1/jobs/{sub['id']}")
        assert code == 200 and st["state"] == "done"
        assert st["blocks_done"] == 4 and st["progress"]["done"] == 4

        code, _, err = c.request("GET", "/v1/jobs/j999")
        assert code == 404 and "no such job" in err["error"]
        code, _, err = c.submit(chain, 16, seed=0, bogus=1)
        assert code == 400 and "bogus" in err["error"]
        code, _, err = c.submit(chain, 16, seed=0,
                                config={"made_up_knob": 2})
        assert code == 400 and "made_up_knob" in err["error"]
        code, _, err = c.submit(chain, 10, seed=0, macro_batches=4)
        assert code == 400 and "divide" in err["error"]
        code, _, err = c.submit(chain, 16, seed=0,
                                config={"runtime": "local"})
        assert code == 400 and "server-side" in err["error"]
        code, _, err = c.submit(chain, 16, seed=0,
                                config={"clamp": {"99": 0}})
        assert code == 400
        code, _, err = c.submit("/nonexistent/store", 16, seed=0)
        assert code == 400 and "store" in err["error"]
        c.conn.request("POST", "/v1/jobs", b"not json{")
        resp = c.conn.getresponse()
        assert resp.status == 400
        resp.read()
        code, _, _ = c.request("GET", "/nowhere")
        assert code == 404
        c.close()


def test_cancel_running_job_streams_error_frame(chain):
    with _service(workers=1) as svc, Gateway(svc) as gw:
        release = threading.Event()
        svc.batch_hook = lambda job, b, w: release.wait(timeout=60)
        c = Client(gw.url)
        code, _, sub = c.submit(chain, 16, seed=9, macro_batches=4)
        assert code == 201
        code, _, out = c.request("DELETE", f"/v1/jobs/{sub['id']}")
        assert code == 200 and out["cancelled"] is True
        release.set()
        _, terminal = c.stream_frames(sub["id"])
        assert terminal["kind"] == "error"
        code, _, st = c.request("GET", f"/v1/jobs/{sub['id']}")
        assert st["state"] == "cancelled"
        c.close()


def test_job_routes_are_tenant_scoped(chain):
    table = TenantTable([Tenant(name="alice", api_key="alice-key"),
                         Tenant(name="mallory", api_key="mallory-key")])
    with _service(workers=1) as svc, Gateway(svc, tenants=table) as gw:
        release = threading.Event()
        svc.batch_hook = lambda job, b, w: release.wait(timeout=60)
        alice = Client(gw.url, api_key="alice-key")
        mallory = Client(gw.url, api_key="mallory-key")
        nokey = Client(gw.url)
        code, _, sub = alice.submit(chain, 8, seed=31)
        assert code == 201
        gid = sub["id"]
        assert len(gid) > 16
        for method, path in [("GET", f"/v1/jobs/{gid}"),
                             ("GET", f"/v1/jobs/{gid}/stream"),
                             ("DELETE", f"/v1/jobs/{gid}")]:
            code, _, _ = mallory.request(method, path)
            assert code == 404, (method, path)
            code, _, _ = nokey.request(method, path)
            assert code == 401, (method, path)
        code, _, st = alice.request("GET", f"/v1/jobs/{gid}")
        assert code == 200 and st["state"] in ("pending", "running")
        release.set()
        assert alice.stream_samples(gid).shape == (8, 10)
        for c in (alice, mallory, nokey):
            c.close()


def test_store_root_confines_client_paths(chain):
    root = os.path.dirname(chain)
    with _service(workers=1) as svc, Gateway(svc, store_root=root) as gw:
        c = Client(gw.url)
        code, _, err = c.submit(chain, 8, seed=0)
        assert code == 400 and "absolute" in err["error"]
        code, _, err = c.submit("../" + os.path.basename(root) + "/"
                                + os.path.basename(chain), 8, seed=0)
        assert code == 400 and "escapes" in err["error"]
        code, _, err = c.submit("../../../../etc", 8, seed=0)
        assert code == 400 and "escapes" in err["error"]
        code, _, sub = c.submit(os.path.basename(chain), 8, seed=0)
        assert code == 201
        assert c.stream_samples(sub["id"]).shape == (8, 10)
        c.close()


def test_store_digest_matches_reference_and_sees_a_rewrite(chain, tmp_path):
    import shutil
    root = str(tmp_path / "copy")
    shutil.copytree(chain, root)
    with JStore(root) as jst:
        want = jst.digest()
    with _service(workers=1) as svc, Gateway(svc) as gw:
        d1, n = gw._store_identity(root)
        assert (d1, n) == (want, 10)
        assert gw._store_identity(root) == (d1, 10)
        site = sorted(f for f in os.listdir(root)
                      if f.startswith("site_"))[0]
        p = os.path.join(root, site)
        st = os.stat(p)
        raw = bytearray(open(p, "rb").read())
        raw[-1] ^= 0xFF
        tmp = p + ".new"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.utime(tmp, ns=(st.st_atime_ns, st.st_mtime_ns))
        os.replace(tmp, p)
        assert gw._store_identity(root)[0] != d1


# ---------------------------------------------------------------------------
# quotas and tenancy
# ---------------------------------------------------------------------------

def test_quota_exhaustion_429_and_recovery(chain):
    table = TenantTable([Tenant(name="t", api_key="tk", max_active_jobs=1)])
    with _service(workers=1) as svc, Gateway(svc, tenants=table) as gw:
        release = threading.Event()
        svc.batch_hook = lambda job, b, w: release.wait(timeout=60)
        c = Client(gw.url, api_key="tk")
        code, _, first = c.submit(chain, 8, seed=1)
        assert code == 201
        code, headers, err = c.submit(chain, 8, seed=2)
        assert code == 429 and int(headers["Retry-After"]) >= 1
        assert "admission" in err
        bad = Client(gw.url, api_key="wrong")
        assert bad.submit(chain, 8, seed=3)[0] == 401
        bad.close()
        release.set()
        assert c.stream_samples(first["id"]).shape == (8, 10)
        deadline = time.monotonic() + 30
        while True:
            code, _, third = c.submit(chain, 8, seed=2)
            if code == 201 or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        assert code == 201
        c.stream_samples(third["id"])
        c.close()
    assert table.stats()["rejected"] == 1


def test_tenant_table_matches_reference(tmp_path):
    """Fair share, quotas and the tenants file, beside the JAX package's
    table on the same calls."""
    spec = {"tenants": [{"name": "a", "api_key": "ak", "priority": 10,
                         "max_active_bytes": 250}]}
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps(spec))
    ours, theirs = TenantTable.from_json(str(path)), JTable.from_json(
        str(path))
    for table in (ours, theirs):
        t = table.resolve("ak")
        got = [table.begin_job(t, 100), table.begin_job(t, 100)]
        assert got == [10, 9]
        table.end_job(t, 100)
        assert table.begin_job(t, 100) == 9
    with pytest.raises(QuotaExceeded):
        ours.begin_job(ours.resolve("ak"), 100)
    with pytest.raises(Exception, match="quota"):
        theirs.begin_job(theirs.resolve("ak"), 100)
    assert ours.stats()["rejected"] == 1
    assert ours.stats() == theirs.stats()
    path.write_text(json.dumps({"tenants": [{"name": "x", "api_key": "k",
                                             "colour": "red"}]}))
    with pytest.raises(ValueError, match="unknown"):
        TenantTable.from_json(str(path))
    assert TenantTable().resolve(None).name == "anonymous"


# ---------------------------------------------------------------------------
# the result cache
# ---------------------------------------------------------------------------

def test_cache_hit_serves_bit_identical_bytes_one_execution(chain, tmp_path):
    cache = ResultCache(cache_dir=str(tmp_path / "cache"))
    with _service(workers=2) as svc, Gateway(svc, cache=cache) as gw:
        c = Client(gw.url)
        _, _, first = c.submit(chain, 16, seed=5, macro_batches=2)
        assert first["cache"] == "miss"
        frames1, _ = c.stream_frames(first["id"])
        _, _, second = c.submit(chain, 16, seed=5, macro_batches=2)
        assert second["cache"] == "hit"
        frames2, _ = c.stream_frames(second["id"])
        assert frames1 == frames2
        assert svc.stats()["jobs"]["done"] == 1
        c.close()
    cache2 = ResultCache(cache_dir=str(tmp_path / "cache"))
    with _service(workers=1) as svc2, Gateway(svc2, cache=cache2) as gw2:
        c2 = Client(gw2.url)
        _, _, again = c2.submit(chain, 16, seed=5, macro_batches=2)
        assert again["cache"] == "hit"
        assert c2.stream_frames(again["id"])[0] == frames1
        assert svc2.stats()["jobs"]["done"] == 0
        c2.close()


def test_inflight_dedup_second_request_attaches(chain):
    with _service(workers=1) as svc, Gateway(svc) as gw:
        release = threading.Event()
        svc.batch_hook = lambda job, b, w: release.wait(timeout=60)
        c1, c2 = Client(gw.url), Client(gw.url)
        _, _, first = c1.submit(chain, 16, seed=11, macro_batches=4)
        assert first["cache"] == "miss"
        _, _, second = c2.submit(chain, 16, seed=11, macro_batches=4)
        assert second["cache"] == "attach"
        # an attacher's DELETE detaches itself, the execution runs on
        code, _, out = c2.request("DELETE", f"/v1/jobs/{second['id']}")
        assert code == 200 and out["cancelled"] is True
        release.set()
        s1 = c1.stream_samples(first["id"])
        assert np.array_equal(s1, _samples(_inprocess_frames(chain, 16, 11,
                                                             4)))
        assert svc.stats()["jobs"]["done"] == 1
        assert gw.cache.stats()["attaches"] == 1
        c1.close()
        c2.close()


@pytest.mark.parametrize("impl", ["port", "reference"])
def test_cache_lru_and_memory_bounds(tmp_path, impl):
    """The LRU byte budget, the bounded memory tier backed by disk, the
    memory-only mode, running entries never evicted, a failed entry not
    poisoning its key: the same outcomes from both packages' caches."""
    Cache = ResultCache if impl == "port" else JCache
    cache = Cache(cache_dir=str(tmp_path / "lru"), max_bytes=3000)
    filler = np.zeros((16, 16), np.float32)
    for i in range(5):
        e, status = cache.get_or_begin(f"key-{i:02d}", 1)
        assert status == "miss"
        e.publish(0, transport.array_to_frame(filler))
        e.finish()
        cache.seal(e)
        time.sleep(0.01)
    st = cache.stats()
    assert st["evictions"] >= 2 and st["disk_bytes"] <= 3000
    surviving = {k for k, _, _ in cache._disk_entries()}
    assert "key-04" in surviving and "key-00" not in surviving

    mem = Cache(cache_dir=str(tmp_path / "mem"), max_memory_entries=2)
    frames = {}
    for i in range(5):
        e, _ = mem.get_or_begin(f"key-{i:02d}", 1)
        frames[i] = transport.array_to_frame(np.full((4, 4), i, np.float32))
        e.publish(0, frames[i])
        e.finish()
        mem.seal(e)
        assert mem.stats()["entries"] <= 2
    e, status = mem.get_or_begin("key-00", 1)
    assert status == "hit" and e.blocks[0] == frames[0]

    only = Cache(max_memory_entries=1)
    running = [only.get_or_begin(f"r{i}", 1)[0] for i in range(2)]
    for i in range(3):
        e, _ = only.get_or_begin(f"k{i}", 1)
        e.publish(0, b"frame")
        e.finish()
        only.seal(e)
    assert only.get_or_begin("k2", 1)[1] == "hit"
    assert only.get_or_begin("k0", 1)[1] == "miss"
    for i in range(2):
        e, status = only.get_or_begin(f"r{i}", 1)
        assert status == "attach" and e is running[i]

    e, _ = only.get_or_begin("boom", 1)
    e.finish(error="boom")
    only.seal(e)
    with pytest.raises(RuntimeError, match="boom"):
        list(e.stream())
    e2, status = only.get_or_begin("boom", 1)
    assert status == "miss" and e2 is not e


def test_cache_key_matches_reference():
    base = ("store", "cfg", 0, 64, 4)
    variants = [base, ("store2", "cfg", 0, 64, 4), ("store", "cfg2", 0, 64, 4),
                ("store", "cfg", 1, 64, 4), ("store", "cfg", 0, 128, 4),
                ("store", "cfg", 0, 64, 2)]
    keys = [cache_key(*v) for v in variants]
    assert len(set(keys)) == 6
    assert keys == [j_cache_key(*v) for v in variants]


def test_gateway_record_table_is_bounded(chain):
    with _service(workers=1) as svc, Gateway(svc, max_records=2) as gw:
        c = Client(gw.url)
        for seed in range(4):
            _, _, sub = c.submit(chain, 8, seed=seed)
            c.stream_samples(sub["id"])
        assert len(gw._records) <= 2
        code, _, st = c.request("GET", f"/v1/jobs/{sub['id']}")
        assert code == 200 and st["state"] == "done"
        c.close()


# ---------------------------------------------------------------------------
# against the JAX package's gateway, and the acceptance cell
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("config", [None, {"segment_len": 3},
                                    {"clamp": {"2": 1}}],
                         ids=["default", "segment_len", "clamp"])
def test_port_gateway_serves_the_reference_gateways_samples(chain, config):
    """The same request on the same store: the JAX package's gateway and
    the port's serve the same samples (frames differ: int32 against the
    port's int64)."""
    with JService(workers=1) as jsvc, JGateway(jsvc) as jgw:
        jc = Client(jgw.url)
        _, _, jsub = jc.submit(chain, 16, seed=21, macro_batches=2,
                               config=config)
        want = jc.stream_samples(jsub["id"])
        jc.close()
    with _service(workers=1) as svc, Gateway(svc) as gw:
        c = Client(gw.url)
        code, _, sub = c.submit(chain, 16, seed=21, macro_batches=2,
                                config=config)
        assert code == 201
        got = c.stream_samples(sub["id"])
        c.close()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_acceptance_two_tenants_one_execution(chain, tmp_path):
    table = TenantTable([
        Tenant(name="alice", api_key="alice-key", priority=5),
        Tenant(name="bob", api_key="bob-key", priority=5),
        Tenant(name="carol", api_key="carol-key", max_active_jobs=1)])
    registry = MetricsRegistry()
    cache = ResultCache(cache_dir=str(tmp_path / "cache"))
    with _service(workers=1) as svc, Gateway(
            svc, tenants=table, cache=cache, registry=registry) as gw:
        instrument_service(svc, registry)
        release = threading.Event()
        svc.batch_hook = lambda job, b, w: release.wait(timeout=120)
        alice = Client(gw.url, api_key="alice-key")
        bob = Client(gw.url, api_key="bob-key")
        carol = Client(gw.url, api_key="carol-key")
        code, _, a = alice.submit(chain, 16, seed=21, macro_batches=4)
        assert code == 201 and a["cache"] == "miss"
        code, _, b = bob.submit(chain, 16, seed=21, macro_batches=4)
        assert code == 201 and b["cache"] == "attach"
        code, _, c1 = carol.submit(chain, 8, seed=99)
        assert code == 201
        code, headers, _ = carol.submit(chain, 8, seed=100)
        assert code == 429 and int(headers["Retry-After"]) >= 1
        release.set()
        a_frames, a_term = alice.stream_frames(a["id"])
        b_frames, b_term = bob.stream_frames(b["id"])
        assert a_term["kind"] == b_term["kind"] == "end"
        assert a_frames == b_frames
        assert a_frames == _inprocess_frames(chain, 16, 21, 4)
        assert cache.stats()["misses"] == 2
        assert cache.stats()["attaches"] == 1
        carol.stream_samples(c1["id"])
        alice.conn.request("GET", "/metrics")
        resp = alice.conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/plain")
        text = resp.read().decode()

        def value(sample):
            for line in text.splitlines():
                if line.startswith(sample + " "):
                    return float(line.split()[-1])
            raise AssertionError(f"{sample} not exposed:\n{text}")

        assert value("fastmps_jobs_submitted_total") == 2
        assert value('fastmps_queue_events_total{event="claim"}') >= 5
        assert value('fastmps_cache_events_total{event="miss"}') >= 2
        assert value('fastmps_cache_events_total{event="attach"}') >= 1
        assert value("fastmps_tenant_rejections_total") == 1
        assert value('fastmps_http_requests_total{route="submit",'
                     'code="429"}') == 1
        assert value("fastmps_batches_total") >= 5
        for c in (alice, bob, carol):
            c.close()
        code, _, st = Client(gw.url, "alice-key").request("GET", "/v1/stats")
        assert code == 200 and st["cache"]["attaches"] == 1
    with Gateway(_service(workers=1)) as bare:
        assert Client(bare.url).request("GET", "/metrics")[0] == 404
        bare.service.close()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_serves_a_request_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    demo = tmp_path / "stores" / "demo"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.gateway", "--device",
         "cpu", "--port", "0", "--serve-s", "60", "--workers", "1",
         "--demo-store", str(demo), "--sites", "5", "--chi", "4",
         "--store-root", str(tmp_path / "stores"), "--cache-dir",
         str(tmp_path / "cache"), "--stats-every", "0"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        url = None
        for line in proc.stdout:
            if line.startswith("gateway listening on "):
                url = line.split()[-1]
                break
        assert url, proc.stderr.read()
        c = Client(url)
        code, _, sub = c.submit("demo", 8, seed=4, macro_batches=2)
        assert code == 201, sub
        got = c.stream_samples(sub["id"])
        c.close()
    finally:
        proc.terminate()
        proc.communicate(timeout=60)
    np.testing.assert_array_equal(got, _samples(_inprocess_frames(
        str(demo), 8, 4, 2)))
