"""The port's fault taxonomy (``repro_torch.runtime.faults``) and the
self-healing paths it drives, against the JAX package's: the counterparts
of ``tests/test_faults.py``'s cases that need no module the port does not
carry (the checkpoint store of model training).

* The taxonomy: the closed kind set, ``to_dict`` / ``with_context``, the
  report, ``classify`` (torch's out-of-memory and ``torch.distributed``
  errors beside the JAX package's matrix) and ``dead_letter_kind``, each
  against the JAX package's answer.
* Wire checksums (frames, segment payloads), verified Γ reads
  (bit rot, a digest mismatch, a torn file: quarantined), a service job on
  a rotted store failing with the structured fault, and the broadcast
  plane shipping a root's read fault as an error frame so every member
  raises it.
* The store's repair functions, the sharded plane's peer repair (a
  rotted copy of an owned site written again from a peer's healthy copy,
  the samples unchanged) and an unrepairable site failing every process
  with ``kind="corruption"``; the result cache dropping a corrupt disk
  entry loudly.
* Bounded retries (a poison batch dead-letters its job only) and the
  crash-loop quarantine with its readmit, on an in-process pool with the
  real ``LaneHealth`` and ``execute_payload``; the sampler-state digest,
  the fault metrics and the CLI's structured exit.
"""
import json
import os
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.gamma_store import GammaStore as JStore  # noqa: E402
from repro.runtime import faults as JF  # noqa: E402
from repro.runtime import transport as JT  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api.remote import execute_payload  # noqa: E402
from repro_torch.api.service import SamplingService  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import gamma_store as GS  # noqa: E402
from repro_torch.data.gamma_store import GammaStore  # noqa: E402
from repro_torch.runtime import transport  # noqa: E402
from repro_torch.runtime.elastic import WorkQueue  # noqa: E402
from repro_torch.runtime.faults import (KINDS, CorruptSegment,  # noqa: E402
                                        CrashLoopLane, DeadLetter, Fault,
                                        FaultReport, classify,
                                        dead_letter_kind)
from repro_torch.runtime.transport import (LaneHealth,  # noqa: E402
                                           TransportError, WorkerDied)

F64 = (torch.float64, torch.float64)


@pytest.fixture(scope="module")
def chain(tmp_path_factory, linear_mps_10x6):
    """A pristine fp64 store with its digest manifest (the JAX package
    wrote both); damage is always done to a copy."""
    root = str(tmp_path_factory.mktemp("faults_gamma"))
    with JStore(root, storage_dtype=jnp.float64,
                compute_dtype=jnp.float64) as store:
        store.write_mps(linear_mps_10x6)
        store.write_digest_manifest()
    return root


def _copy_store(src: str, dst: str) -> str:
    shutil.copytree(src, dst)
    return dst


def _flip_bytes(path: str, n: int = 8) -> None:
    with open(path, "r+b") as f:
        f.seek(0, os.SEEK_END)
        mid = f.tell() // 2
        f.seek(mid)
        chunk = f.read(n)
        f.seek(mid)
        f.write(bytes(b ^ 0xFF for b in chunk))


def _site_path(root: str, i: int) -> str:
    return os.path.join(root, GS.site_filename(i))


def _baseline(root, n_samples, key, macro_batches):
    with SamplingService(workers=1, device="cpu") as svc:
        return svc.submit(root, n_samples=n_samples, key=key,
                          macro_batches=macro_batches).result(timeout=300)


class _FakeWorker:
    def __init__(self):
        self.alive = True
        self.batches = 0
        self.dispatch_bytes = 0


class FakePool:
    """An in-process WorkerPool: the real ``LaneHealth`` and
    ``execute_payload`` (on the CPU), and a ``fail_filter(name, payload)``
    that kills the (fake) worker."""

    def __init__(self, health=None):
        self.workers: dict[str, _FakeWorker] = {}
        self.injectors: list = []
        self.spawned = self.reaped = self.faults = 0
        self.health = LaneHealth() if health is None else health
        self.observer = None
        self.fail_filter = None
        self._cache: dict = {}

    def spawn(self, name):
        w = self.workers[name] = _FakeWorker()
        self.spawned += 1
        return w

    def reap(self, name, kill=False):
        if self.workers.pop(name, None) is not None:
            self.reaped += 1

    def respawn(self, name):
        delay = self.health.check_respawn(name)
        if delay:
            time.sleep(min(delay, 0.05))
        self.reap(name, kill=True)
        return self.spawn(name)

    def call(self, name, payload):
        w = self.workers.get(name)
        if w is None:
            raise WorkerDied(f"no worker {name!r} in the pool")
        try:
            if self.fail_filter is not None and self.fail_filter(name,
                                                                 payload):
                w.alive = False
                raise WorkerDied(f"worker {name!r} killed by injected fault")
            out = execute_payload(payload, cache=self._cache, device="cpu")
            w.batches += 1
            self.health.record_success(name)
            return out
        except TransportError:
            self.faults += 1
            self.health.record_fault(name)
            raise

    def stats(self):
        out = {"workers": len(self.workers), "spawned": self.spawned,
               "reaped": self.reaped, "faults": self.faults,
               "batches": {n: w.batches for n, w in self.workers.items()},
               "dispatch_bytes": 0}
        out.update(self.health.stats())
        return out

    def close(self):
        self.workers.clear()
        for sess in self._cache.values():
            sess.close()
        self._cache.clear()


# ---------------------------------------------------------------------------
# the taxonomy
# ---------------------------------------------------------------------------

def test_fault_kind_closed_set():
    assert KINDS == JF.KINDS
    for k in KINDS:
        Fault(kind=k, message="ok")
    with pytest.raises(ValueError):
        Fault(kind="gremlins", message="no such kind")


def test_fault_to_dict_and_context():
    f = Fault(kind="corruption", message="m", site=3, at=1.5)
    d = f.to_dict()
    assert d == JF.Fault(kind="corruption", message="m", site=3,
                         at=1.5).to_dict()
    assert "batch" not in d and "lane" not in d
    g = f.with_context(site=9, batch=1, lane="lane-0")
    assert g.site == 3 and g.batch == 1 and g.lane == "lane-0"
    assert f.with_context() is f


def test_fault_report_counts_and_dict():
    r, jr = FaultReport(), JF.FaultReport()
    for kind, kw in (("transport", {"batch": 1}), ("transport", {"batch": 1}),
                     ("corruption", {"site": 4})):
        r.add(Fault(kind=kind, message="x", at=0.0, **kw))
        jr.add(JF.Fault(kind=kind, message="x", at=0.0, **kw))
    assert r.counts() == jr.counts()
    assert r.counts()["poison"] == 0
    assert r.to_dict() == jr.to_dict()


def test_classify_matrix():
    cases = [
        (WorkerDied("gone"), JT.WorkerDied("gone"), "transport"),
        (TransportError("x exceeded the 5s deadline"),
         JT.TransportError("x exceeded the 5s deadline"), "timeout"),
        (TransportError("pipe broke"), JT.TransportError("pipe broke"),
         "transport"),
        (TimeoutError("slow"), TimeoutError("slow"), "timeout"),
        (MemoryError(), MemoryError(), "resource"),
        (OSError("disk full"), OSError("disk full"), "resource"),
    ]
    for mine, theirs, kind in cases:
        assert classify(mine, batch=2).kind == kind
        assert JF.classify(theirs, batch=2).kind == kind
    assert classify(ValueError("a plain job error")) is None
    inner = CorruptSegment(Fault(kind="corruption", message="rot", site=7))
    out = classify(inner, batch=3, site=99)
    assert out.kind == "corruption" and out.site == 7 and out.batch == 3
    # torch's counterparts of the device and collective errors
    assert classify(torch.OutOfMemoryError("CUDA out of memory")
                    ).kind == "resource"
    dist = torch.distributed
    assert classify(dist.DistNetworkError("connection reset")
                    ).kind == "transport"
    assert classify(dist.DistBackendError("gloo: Timed out waiting")
                    ).kind == "timeout"
    assert classify(RuntimeError("a numerical check")) is None


def test_dead_letter_kind_poison_signature():
    def t():
        return Fault(kind="transport", message="died", batch=0)
    assert dead_letter_kind([t(), t(), t()]) == "poison"
    assert dead_letter_kind([t(), t()]) == "poison"
    assert dead_letter_kind([t()]) == "transport"
    assert dead_letter_kind([]) == "transport"
    timeouts = [Fault(kind="timeout", message="ewma", batch=0)] * 2 + [t()]
    assert dead_letter_kind(timeouts) == "timeout" == JF.dead_letter_kind(
        [JF.Fault(kind=f.kind, message=f.message) for f in timeouts])


def test_workqueue_counts_attempts():
    q = WorkQueue(2)
    assert q.attempts(0) == 0
    b = q.claim("w0", now=0.0)
    assert q.attempts(b) == 1
    q.fail("w0")
    assert q.claim("w1", now=0.0) == b
    assert q.attempts(b) == 2
    q.complete(b, worker="w1")
    assert q.attempts(b) == 2


# ---------------------------------------------------------------------------
# wire checksums, verified reads
# ---------------------------------------------------------------------------

def test_frame_crc_mismatch_rejected_at_decode():
    import io
    buf = io.BytesIO()
    transport.write_frame(buf, b"hello fastmps frame")
    data = bytearray(buf.getvalue())
    data[-3] ^= 0x01
    with pytest.raises(TransportError) as ei:
        transport.read_frame(io.BytesIO(bytes(data)))
    assert not isinstance(ei.value, WorkerDied)
    assert "checksum" in str(ei.value)


def test_segment_payload_crc_rejected(chain):
    with GammaStore(chain, *F64) as store:
        payload = store.get_segment_raw(2, 2)
        GS.decode_segment(payload)
        bad = dict(payload)
        lam = np.array(payload["lam"], copy=True)
        lam.flat[0] += 1.0
        bad["lam"] = lam
        with pytest.raises(CorruptSegment) as ei:
            GS.decode_segment(bad)
        assert ei.value.fault.kind == "corruption"
        assert ei.value.fault.site == 2


def test_bitflip_detected_and_quarantined(chain, tmp_path):
    root = _copy_store(chain, str(tmp_path / "rot"))
    _flip_bytes(_site_path(root, 3))
    with GammaStore(root, *F64) as store:
        with pytest.raises(CorruptSegment) as ei:
            store.get_segment(2, 2)
        f = ei.value.fault
        assert f.kind == "corruption" and f.site == 3 and f.store == root
        assert store.quarantined_sites == 1
    assert not os.path.exists(_site_path(root, 3))
    assert os.path.exists(_site_path(root, 3) + ".quarantine")


def test_digest_mismatch_detected_when_verify_on(chain, tmp_path):
    root = _copy_store(chain, str(tmp_path / "stale"))
    with GammaStore(root, *F64, verify=True) as store:
        g, lam = store.get(0, prefetch_next=False)
        assert store.verified_reads >= 1
        np.savez(_site_path(root, 2), gamma=np.zeros(tuple(g.shape)),
                 gshape=np.array(g.shape), lam=np.zeros(tuple(lam.shape)),
                 two_byte=np.array(False))
        with pytest.raises(CorruptSegment) as ei:
            store.get(2, prefetch_next=False)
        assert ei.value.fault.kind == "corruption"
        assert "digest" in ei.value.fault.message
    assert os.path.exists(_site_path(root, 2) + ".quarantine")


def test_truncated_site_detected(chain, tmp_path):
    root = _copy_store(chain, str(tmp_path / "torn"))
    path = _site_path(root, 5)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    with GammaStore(root, *F64) as store:
        with pytest.raises(CorruptSegment):
            store.get(5, prefetch_next=False)
    assert os.path.exists(path + ".quarantine")


def test_corrupt_store_fails_job_with_structured_fault(chain, tmp_path):
    root = _copy_store(chain, str(tmp_path / "svc_rot"))
    _flip_bytes(_site_path(root, 3))
    with SamplingService(workers=1, device="cpu") as svc:
        h = svc.submit(root, api.SamplerConfig(backend="streamed",
                                               segment_len=2),
                       n_samples=8, key=prng.key(0))
        with pytest.raises(CorruptSegment):
            h.result(timeout=120)
        assert h.status() == "failed"
        assert h.fault_report()["counts"]["corruption"] >= 1
        assert svc.stats()["faults"]["corruption"] >= 1


def test_broadcast_plane_corrupt_site_fails_every_process(chain, tmp_path):
    """The root finds the rot, ships the fault as an error frame, and every
    member raises the same structured fault instead of hanging."""
    root = _copy_store(chain, str(tmp_path / "bcast_rot"))
    _flip_bytes(_site_path(root, 9))
    outs, errs = {}, {}

    def run(rt):
        try:
            with api.SamplingSession(root, api.SamplerConfig(
                    runtime=rt, backend="streamed", segment_len=2),
                    device="cpu") as sess:
                outs[rt.process_index] = sess.sample(8, prng.key(3))
        except BaseException as e:      # noqa: BLE001 — asserted below
            errs[rt.process_index] = e

    threads = [threading.Thread(target=run, args=(rt,), daemon=True)
               for rt in api.emulated_cluster(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "cluster run hung"
    assert not outs
    assert set(errs) == {0, 1}
    for e in errs.values():
        assert isinstance(e, CorruptSegment)
        assert e.fault.kind == "corruption" and e.fault.site == 9


# ---------------------------------------------------------------------------
# bounded retries, dead letters, crash-loop quarantine
# ---------------------------------------------------------------------------

def test_poison_batch_dead_letters_its_job_only(chain):
    key = prng.key(11)
    ref = _baseline(chain, 16, key, 2)
    pool = FakePool(health=LaneHealth(backoff_base=0.001))
    pool.fail_filter = (lambda name, payload:
                        (payload.get("job") or {}).get("job_id") == 0
                        and payload["job"]["batch_id"] == 1)
    try:
        with SamplingService(workers=1, pool=pool,
                             max_batch_attempts=3) as svc:
            h_poison = svc.submit(chain, n_samples=16, key=key,
                                  macro_batches=2)
            with pytest.raises(DeadLetter) as ei:
                h_poison.result(timeout=300)
            assert h_poison.status() == "failed"
            assert ei.value.fault.kind == "poison"
            assert ei.value.report.dead_letter == {
                "batch": 1, "attempts": 3, "kind": "poison"}
            report = h_poison.fault_report()
            assert report["counts"]["transport"] == 3
            assert report["counts"]["poison"] == 1
            assert h_poison.progress["blocks"] == 1
            h_ok = svc.submit(chain, n_samples=16, key=key, macro_batches=2)
            np.testing.assert_array_equal(h_ok.result(timeout=300), ref)
            st = svc.stats()
            assert st["dead_letters"] == 1
            assert st["faults"]["poison"] == 1
            assert st["faults"]["transport"] == 3
            assert st["transport"]["lane_quarantines"] == 0
    finally:
        pool.close()


def test_crash_loop_lane_quarantined_then_readmitted(chain):
    key = prng.key(17)
    ref = _baseline(chain, 32, key, 4)
    broken = {"lane-0"}
    pool = FakePool(health=LaneHealth(backoff_base=0.001,
                                      max_faults_per_window=2))
    pool.fail_filter = lambda name, payload: name in broken
    try:
        with SamplingService(workers=2, pool=pool, max_batch_attempts=50,
                             lane_quarantine_s=0.4) as svc:
            h = svc.submit(chain, n_samples=32, key=key, macro_batches=4)
            np.testing.assert_array_equal(h.result(timeout=300), ref)
            deadline = time.monotonic() + 30
            while (svc.stats()["transport"]["lane_quarantines"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            st = svc.stats()
            assert st["transport"]["lane_quarantines"] == 1
            assert st["faults"]["transport"] >= 2
            broken.clear()
            deadline = time.monotonic() + 30
            while (svc.stats()["transport"]["lane_readmits"] < 1
                   and time.monotonic() < deadline):
                time.sleep(0.02)
            st = svc.stats()
            assert st["transport"]["lane_readmits"] == 1
            assert st["transport"]["quarantined"] == []
            assert "lane-0" in svc.workers()
    finally:
        pool.close()


def test_lane_health_forgive_clears_window():
    h = LaneHealth(max_faults_per_window=2, backoff_base=0.001)
    h.record_fault("w")
    h.record_fault("w")
    with pytest.raises(CrashLoopLane) as ei:
        h.check_respawn("w")
    assert ei.value.fault.lane == "w"
    h.forgive("w")
    assert h.window_faults("w") == 0
    assert h.check_respawn("w") == 0.0


# ---------------------------------------------------------------------------
# checkpoints, metrics, the CLI
# ---------------------------------------------------------------------------

def test_sampler_state_digest_detects_tamper(tmp_path):
    from repro_torch.checkpoint.sampler_state import (load_sampler_state,
                                                      save_sampler_state)
    from repro_torch.core.sampler import SamplerState

    state = SamplerState(torch.ones((4, 6), dtype=torch.float64),
                         prng.key(0), torch.zeros((4,), dtype=torch.float64))
    samples = np.arange(8, dtype=np.int8).reshape(4, 2)
    fn = save_sampler_state(str(tmp_path), 3, state, samples)
    site, loaded, got = load_sampler_state(str(tmp_path))
    assert site == 3
    np.testing.assert_array_equal(got, samples)
    with np.load(fn) as z:
        arrs = {k: z[k] for k in z.files}
    arrs["samples"] = arrs["samples"] + 1
    np.savez(fn, **arrs)
    with pytest.raises(CorruptSegment) as ei:
        load_sampler_state(str(tmp_path))
    assert ei.value.fault.kind == "corruption" and ei.value.fault.site == 3


def test_fault_metrics_rendered():
    from repro_torch.obs import MetricsRegistry, instrument_service

    reg = MetricsRegistry()
    with SamplingService(workers=0, device="cpu") as svc:
        obs = instrument_service(svc, reg)
        obs("fault", kind="corruption")
        obs("fault", kind="poison")
        obs("lane_quarantine", worker="lane-0")
        obs("lane_readmit", worker="lane-0")
        snap = reg.snapshot()
    faults = snap["fastmps_faults_total"]
    assert faults[("", (("kind", "corruption"),))] == 1
    assert faults[("", (("kind", "poison"),))] == 1
    assert snap["fastmps_lane_quarantines_total"][("", ())] == 1
    assert snap["fastmps_lane_readmits_total"][("", ())] == 1
    assert snap["fastmps_dead_letters"][("", ())] == 0
    assert snap["fastmps_quarantined_lanes"][("", ())] == 0
    assert 'fastmps_faults_total{kind="corruption"}' in reg.render()


def test_metrics_render_like_the_reference():
    """The same events into both packages' registries render the same
    Prometheus text."""
    from repro.obs.metrics import MetricsRegistry as JReg
    from repro_torch.obs.metrics import MetricsRegistry

    texts = []
    for reg in (MetricsRegistry(), JReg()):
        c = reg.counter("fastmps_x_total", "x", ["kind"])
        c.labels(kind="poison").inc(2)
        reg.gauge("fastmps_g", "g").set(1.5)
        h = reg.histogram("fastmps_h_seconds", "h", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 5.0):
            h.observe(v)
        texts.append(reg.render())
    assert texts[0] == texts[1]


def test_launch_cli_structured_failure_on_corrupt_store(chain, tmp_path,
                                                        capsys):
    """The CLI on a rotted store exits 2 with a JSON fault record on
    stderr and writes no batch file."""
    from repro_torch.launch import sample as cli

    root = _copy_store(chain, str(tmp_path / "cli_rot"))
    _flip_bytes(_site_path(root, 3))
    out_dir = str(tmp_path / "cli_out")
    with pytest.raises(SystemExit) as ei:
        cli.main(["--stream", "--store", root, "--sites", "10", "--chi", "6",
                  "--samples", "8", "--macro-batches", "1", "--segment-len",
                  "2", "--device", "cpu", "--scheme", "seq", "--out",
                  out_dir])
    assert ei.value.code == 2
    err = capsys.readouterr().err
    i = err.rindex('"fault"')
    record = json.loads(err[err.rindex("{", 0, i):])
    assert record["fault"]["kind"] == "corruption"
    assert record["fault"]["site"] == 3
    assert not [f for f in os.listdir(out_dir) if f.startswith("batch_")]


# ---------------------------------------------------------------------------
# peer repair (the sharded plane) and the result cache
# ---------------------------------------------------------------------------

def test_repair_functions_match_the_reference(chain, tmp_path):
    root = _copy_store(chain, str(tmp_path / "rep"))
    pristine = open(_site_path(root, 3), "rb").read()
    with GammaStore(root, *F64) as st, JStore(
            root, storage_dtype=jnp.float64,
            compute_dtype=jnp.float64) as jst:
        assert st.has_healthy_copy(3) and jst.has_healthy_copy(3)
        data = st.read_repair_bytes(3)
        assert data == jst.read_repair_bytes(3) == pristine
        assert st.repair_read_bytes == len(pristine)
        assert st.payload_reads == 0            # not a payload read
        _flip_bytes(_site_path(root, 3))
        assert not st.has_healthy_copy(3)
        with pytest.raises(CorruptSegment, match="itself corrupt"):
            st.read_repair_bytes(3)
        with pytest.raises(CorruptSegment, match="refusing"):
            st.restore_site(3, data[:-1] + bytes([data[-1] ^ 1]))
        assert st.verify_sites([3]) == [3]      # quarantined
        assert not st.has_healthy_copy(3)
        st.restore_site(3, data)
        assert st.repaired_sites == 1 and st.has_healthy_copy(3)
        assert open(_site_path(root, 3), "rb").read() == pristine
        assert not os.path.exists(_site_path(root, 3) + ".quarantine")
        assert not st.has_healthy_copy(99)


def _sharded_cluster(sources, key):
    outs, stats, errs = {}, {}, {}

    def run(rt):
        try:
            with api.SamplingSession(sources[rt.process_index],
                                     api.SamplerConfig(
                                         runtime=rt, backend="streamed",
                                         segment_len=2, shard="auto",
                                         kernels="torch"),
                                     device="cpu") as sess:
                outs[rt.process_index] = sess.sample(16, key)
                stats[rt.process_index] = dict(sess.stats)
        except BaseException as e:      # noqa: BLE001 — asserted below
            errs[rt.process_index] = e

    threads = [threading.Thread(target=run, args=(rt,), daemon=True)
               for rt in api.emulated_cluster(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "cluster run hung"
    return outs, stats, errs


def test_sharded_peer_repair_restores_the_rotted_copy(chain, tmp_path):
    """Host 0 walks its slice of the store (``materialize_shard``: hard
    links and the manifest) with one owned site a rotted copy; host 1
    walks the shared root.  The pre-walk round writes the site again from
    host 1's healthy copy and the samples are the local walk's."""
    from repro_torch.shard import ShardMap, ShardedGammaStore
    from repro_torch.shard import materialize_shard
    key = prng.key(23)
    with api.SamplingSession(GammaStore(chain, *F64), api.SamplerConfig(
            backend="streamed", segment_len=2, kernels="torch"),
            device="cpu") as sess:
        ref = sess.sample(16, key)
    shared = _copy_store(chain, str(tmp_path / "shared"))
    sm = ShardMap(10, 2, 2)             # block 2: site 4 is host 0's
    r0 = materialize_shard(shared, str(tmp_path / "host0"), sm, 0)
    pristine = open(_site_path(r0, 4), "rb").read()
    # a hard link shares the file with the shared root: copy it, then rot
    os.remove(_site_path(r0, 4))
    shutil.copyfile(_site_path(shared, 4), _site_path(r0, 4))
    _flip_bytes(_site_path(r0, 4))
    sources = {0: ShardedGammaStore(r0, sm, 0, *F64),
               1: GammaStore(shared, *F64)}
    outs, stats, errs = _sharded_cluster(sources, key)
    assert not errs, errs
    np.testing.assert_array_equal(outs[0], ref)
    np.testing.assert_array_equal(outs[1], ref)
    assert stats[0]["quarantined_sites"] == 1
    assert (stats[0]["repaired_sites"], stats[1]["repaired_sites"]) == (1, 0)
    assert open(_site_path(r0, 4), "rb").read() == pristine
    assert not os.path.exists(_site_path(r0, 4) + ".quarantine")
    with open(_site_path(shared, 4), "rb") as f:
        assert f.read() == pristine     # the healthy copy was not touched


def test_sharded_unrepairable_site_fails_every_process(chain, tmp_path):
    """The only copy of an owned site is rotted: every process raises the
    same structured fault in the same round, none hangs, none samples."""
    root = _copy_store(chain, str(tmp_path / "shard_rot"))
    _flip_bytes(_site_path(root, 4))
    outs, _, errs = _sharded_cluster({0: root, 1: root}, prng.key(5))
    assert not outs
    assert set(errs) == {0, 1}
    for e in errs.values():
        assert isinstance(e, CorruptSegment)
        assert e.fault.kind == "corruption" and e.fault.site == 4
        assert "no peer holds a healthy copy" in e.fault.message


def test_result_cache_corrupt_entry_dropped_loudly(tmp_path):
    from repro_torch.serve.cache import ResultCache

    d = str(tmp_path / "cache")
    c1 = ResultCache(cache_dir=d)
    entry, status = c1.get_or_begin("k1", 1)
    assert status == "miss"
    entry.publish(0, transport.array_to_frame(np.arange(6, dtype=np.int8)))
    entry.finish()
    c1.seal(entry)
    assert ResultCache(cache_dir=d).get_or_begin("k1", 1)[1] == "hit"
    with open(os.path.join(d, "k1", "meta.json"), "w") as f:
        f.write("{this is not json")
    events = []
    c3 = ResultCache(cache_dir=d)
    c3.observer = lambda ev, **kw: events.append((ev, kw))
    assert c3.get_or_begin("k1", 1)[1] == "miss"
    assert c3.corrupt_entries == 1
    assert c3.stats()["corrupt_entries"] == 1
    assert ("cache_corrupt", {"key": "k1"}) in events
    assert not os.path.exists(os.path.join(d, "k1"))
