"""The port's fleet (``repro_torch.runtime.transport``, ``elastic``,
``stragglers`` and the service's fleet lanes) against the JAX package's:
the counterparts of ``tests/test_fleet.py``.

* The framed protocol (JSON and npy frames, EOF, the CRC).
* The WorkQueue: the 25 seeded storms of ``tests/chaos.py`` run on the
  port's queue (its invariants checked after every step) and in lockstep
  with the JAX package's queue, which must answer every call the same;
  double completion, steal, late completion after a reclaim.
* The straggler EWMA and ``maybe_steal``.
* Thread-lane chaos: a stalled lane's batch reclaimed by an idle one, a
  lane killed mid-job; admission backpressure and always-admit-one.
* Three cases that start CPU worker processes (``--device cpu``): fleet
  lanes with a mid-job kill and a dropped result, the ``remote`` runtime's
  persistent and one-shot workers, and a worker started for the card
  where there is none, whose first call fails.
Every result is compared exactly with the single-lane local run and with
the JAX package's service on the same store and key.
"""
import io
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.runtime.elastic as j_elastic  # noqa: E402
from chaos import (DropResult, KillLane, QueueInvariantError,  # noqa: E402
                   run_queue_script)
from repro import api as japi  # noqa: E402
from repro.data.gamma_store import GammaStore as JStore  # noqa: E402
from repro.runtime.elastic import WorkQueue as JWorkQueue  # noqa: E402
from repro.runtime.stragglers import StragglerMitigator as JMit  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api.service import SamplingService  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.runtime import transport  # noqa: E402
from repro_torch.runtime.elastic import WorkQueue  # noqa: E402
from repro_torch.runtime.stragglers import StragglerMitigator  # noqa: E402


@pytest.fixture(scope="module")
def chain(tmp_path_factory, linear_mps_10x6):
    root = str(tmp_path_factory.mktemp("fleet_gamma"))
    with JStore(root, storage_dtype=jnp.float64,
                compute_dtype=jnp.float64) as store:
        store.write_mps(linear_mps_10x6)
    return root


def _baseline(root, n_samples, key, macro_batches):
    """The single-lane local run the fleet must match."""
    with SamplingService(workers=1, device="cpu") as svc:
        h = svc.submit(root, api.SamplerConfig(kernels="torch"),
                       n_samples=n_samples, key=key,
                       macro_batches=macro_batches)
        return h.result(timeout=300)


def _reference(root, n_samples, seed, macro_batches):
    """The JAX package's service on the same store and key."""
    with japi.SamplingService(workers=1) as svc:
        h = svc.submit(root, n_samples=n_samples, key=jax.random.key(seed),
                       macro_batches=macro_batches)
        return np.asarray(h.result(timeout=300))


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def test_frame_roundtrip():
    buf = io.BytesIO()
    transport.write_json(buf, {"kind": "batch", "payload": {"x": 1}})
    transport.write_frame(buf, transport.array_to_frame(
        np.arange(12, dtype=np.float64).reshape(3, 4)))
    buf.seek(0)
    assert transport.read_json(buf) == {"kind": "batch", "payload": {"x": 1}}
    out = transport.array_from_frame(transport.read_frame(buf))
    np.testing.assert_array_equal(out, np.arange(12.0).reshape(3, 4))


def test_frames_are_the_reference_frames():
    from repro.runtime import transport as jt
    buf = io.BytesIO()
    transport.write_json(buf, {"kind": "result"})
    assert buf.getvalue() == (lambda b: (jt.write_json(b, {
        "kind": "result"}), b.getvalue())[1])(io.BytesIO())
    buf.seek(0)
    assert jt.read_json(buf) == {"kind": "result"}


def test_frame_eof_raises_worker_died():
    with pytest.raises(transport.WorkerDied):
        transport.read_frame(io.BytesIO(b"\x00\x00\x00"))
    half = io.BytesIO()
    transport.write_frame(half, b"full frame")
    with pytest.raises(transport.WorkerDied):
        transport.read_frame(io.BytesIO(half.getvalue()[:-4]))


def test_transport_error_is_not_a_job_error():
    assert issubclass(transport.TransportError, RuntimeError)
    assert issubclass(transport.WorkerDied, transport.TransportError)


# ---------------------------------------------------------------------------
# the queue
# ---------------------------------------------------------------------------

def test_double_complete_rejected():
    q = WorkQueue(2)
    assert q.claim("a", now=0.0) == 0
    assert q.complete(0, worker="a") is True
    assert q.complete(0, worker="a") is False
    assert q.complete(0) is False
    assert q.stats()["done"] == 1


def test_steal_reassigns_and_leaves_fifo_clean():
    q = WorkQueue(3)
    assert q.claim("a", now=0.0) == 0
    assert q.claim("b", now=0.0) == 1
    assert q.reclaim_stale(5.0, now=10.0) == [0, 1]
    assert q.steal(0, "c", now=10.0) is True
    assert q.records[0].owner == "c"
    assert q.claim("d", now=10.0) == 1
    assert q.claim("d", now=10.0) == 2
    assert q.steal(1, "e") is False
    q.complete(2, worker="d")
    assert q.steal(2, "e") is False


def test_late_completion_after_reclaim_rejected():
    q = WorkQueue(1)
    q.claim("slow", now=0.0)
    q.reclaim_stale(1.0, now=100.0)
    assert q.steal(0, "fast", now=100.0)
    assert q.complete(0, worker="slow") is False
    assert q.complete(0, worker="fast") is True
    assert q.stats()["done"] == 1


def _random_ops(rng: random.Random, n_ops: int):
    kinds = ["add", "remove", "claim", "claim", "claim", "complete",
             "complete", "reclaim", "tick"]
    ops = []
    for _ in range(n_ops):
        k = rng.choice(kinds)
        if k == "tick":
            ops.append(("tick",))
        else:
            ops.append((k, rng.randint(0, 3)))
    return ops


def _lockstep(n_batches: int, ops) -> None:
    """Drive the port's and the JAX package's queue with the same calls;
    every answer and every stats snapshot must agree."""
    qs = (WorkQueue(n_batches), JWorkQueue(n_batches))
    claims: dict[str, list[int]] = {}
    now = 0.0
    for op in ops:
        w = f"w{op[1]}" if len(op) > 1 else None
        if op[0] == "tick":
            now += 1.0
            continue
        if op[0] == "add":
            got = [q.add_worker(w) for q in qs]
        elif op[0] == "remove":
            got = [q.remove_worker(w) for q in qs]
        elif op[0] == "claim":
            got = [q.claim(w, now=now) for q in qs]
            if got[0] is not None:
                claims.setdefault(w, []).append(got[0])
        elif op[0] == "complete":
            b = (claims.get(w) or [None]).pop(0) if claims.get(w) else None
            got = [None if b is None else q.complete(b, worker=w)
                   for q in qs]
        else:
            got = [q.reclaim_stale(float(op[1]), now=now) for q in qs]
        assert got[0] == got[1], (op, got)
        assert qs[0].stats() == qs[1].stats(), op
        assert [qs[0].attempts(b) for b in range(n_batches)] == \
            [qs[1].attempts(b) for b in range(n_batches)]


@pytest.mark.parametrize("seed", range(25))
def test_queue_storm_never_loses_or_double_counts(seed, monkeypatch):
    rng = random.Random(seed)
    n_batches = rng.randint(1, 12)
    ops = _random_ops(rng, 120)
    # chaos.run_queue_script interprets the ops on the queue class it finds
    # in repro.runtime.elastic: point it at the port's
    monkeypatch.setattr(j_elastic, "WorkQueue", WorkQueue)
    out = run_queue_script(n_batches, ops)
    assert all(v == 1 for v in out["counted"].values())
    assert len(out["counted"]) == n_batches
    monkeypatch.undo()
    _lockstep(n_batches, ops)


def test_queue_script_catches_a_planted_violation(monkeypatch):
    monkeypatch.setattr(j_elastic, "WorkQueue", WorkQueue)
    monkeypatch.setattr(WorkQueue, "complete",
                        lambda self, b, worker=None: True)
    with pytest.raises(QueueInvariantError):
        run_queue_script(2, [("add", 0), ("claim", 0), ("complete", 0)])


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------

def test_ewma_deadline_math():
    m = StragglerMitigator(WorkQueue(1), k=2.0, ewma_alpha=0.5)
    jm = JMit(JWorkQueue(1), k=2.0, ewma_alpha=0.5)
    assert m.deadline is None and m.stats()["ewma_s"] is None
    for d in (4.0, 2.0, 7.5, 0.25):
        m.observe_completion(d)
        jm.observe_completion(d)
        assert m.stats() == jm.stats()
    m2 = StragglerMitigator(WorkQueue(1), k=2.0, ewma_alpha=0.5)
    m2.observe_completion(4.0)
    assert m2.deadline == pytest.approx(8.0)
    m2.observe_completion(2.0)
    assert m2._ewma == pytest.approx(3.0)


def test_maybe_steal_respects_deadline():
    q = WorkQueue(2)
    m = StragglerMitigator(q, k=2.0, ewma_alpha=0.5)
    q.claim("slow", now=0.0)
    assert m.maybe_steal("idle", now=100.0) is None
    m.observe_completion(1.0)
    assert m.maybe_steal("idle", now=1.5) is None
    assert m.maybe_steal("idle", now=3.0) == 0
    assert q.records[0].owner == "idle" and m.duplicates == 1
    assert q.complete(0, worker="slow") is False
    assert q.complete(0, worker="idle") is True


# ---------------------------------------------------------------------------
# thread-lane chaos, admission
# ---------------------------------------------------------------------------

def test_straggler_reclaim_thread_lanes(chain):
    key = prng.key(11)
    ref = _baseline(chain, 96, key, 6)
    np.testing.assert_array_equal(ref, _reference(chain, 96, 11, 6))
    stalled = {}
    with SamplingService(workers=2, straggler_k=0.2, steal_poll_s=0.01,
                         device="cpu") as svc:
        def stall_last(job, b, worker):
            if b != 5 or stalled:
                return
            stalled["lane"] = worker
            t0 = time.monotonic()
            while (job.queue.records[b].owner == worker
                   and time.monotonic() - t0 < 60.0):
                time.sleep(0.01)

        svc.batch_hook = stall_last
        h = svc.submit(chain, api.SamplerConfig(kernels="torch"),
                       n_samples=96, key=key, macro_batches=6)
        np.testing.assert_array_equal(h.result(timeout=300), ref)
        st = svc.stats()
        assert h.progress["duplicates"] >= 1
        assert st["stragglers"]["duplicates"] >= 1
        assert st["stragglers"]["steals"] >= 1
        assert st["faults"]["timeout"] >= 1
    assert stalled and h.progress["done"] == 6


def test_kill_lane_thread_mode(chain):
    key = prng.key(13)
    ref = _baseline(chain, 64, key, 4)
    with SamplingService(workers=2, straggler_k=None, device="cpu") as svc:
        kill = KillLane(svc, on_batch=1)
        svc.batch_hook = kill
        h = svc.submit(chain, api.SamplerConfig(kernels="torch"),
                       n_samples=64, key=key, macro_batches=4)
        out = h.result(timeout=300)
    assert kill.victim is not None
    np.testing.assert_array_equal(out, ref)
    assert h.progress["requeues"] >= 1


def test_admission_backpressure(chain):
    key = prng.key(17)
    with SamplingService(workers=0, device="cpu") as probe:
        mb = probe.submit(chain, n_samples=32, key=key).progress[
            "model_bytes"]
    with japi.SamplingService(workers=0) as jprobe:
        assert jprobe.submit(chain, n_samples=32, key=jax.random.key(17)
                             ).progress["model_bytes"] == mb
    assert mb > 0
    gate, started = threading.Event(), threading.Event()
    with SamplingService(workers=1, max_active_bytes=1.5 * mb,
                         device="cpu") as svc:
        def hold_first(job, b, worker):
            if job.job_id == 0:
                started.set()
                gate.wait(timeout=60.0)

        svc.batch_hook = hold_first
        h1 = svc.submit(chain, n_samples=32, key=key)
        assert started.wait(timeout=60.0)
        h2 = svc.submit(chain, n_samples=32, key=prng.key(18))
        time.sleep(0.05)
        st = svc.stats()
        assert st["admission"]["queued_jobs"] == 1
        assert st["admission"]["backpressure"] is True
        assert st["admission"]["active_model_bytes"] == pytest.approx(mb)
        assert st["queue_depth"] == 2
        gate.set()
        r1, r2 = h1.result(timeout=300), h2.result(timeout=300)
        st = svc.stats()
        assert st["admission"]["backpressure"] is False
    assert r1.shape == r2.shape == (32, 10)
    assert not np.array_equal(r1, r2)


def test_admission_always_admits_one(chain):
    key = prng.key(19)
    ref = _baseline(chain, 32, key, 1)
    with SamplingService(workers=1, max_active_bytes=1.0,
                         device="cpu") as svc:
        out = svc.submit(chain, n_samples=32, key=key).result(timeout=300)
    np.testing.assert_array_equal(out, ref)


def test_fleet_submit_validation(chain, tmp_path):
    with SamplingService(workers=0, pool=True, device="cpu") as svc:
        with pytest.raises(ValueError, match="skip_batches"):
            svc.submit(chain, n_samples=8, key=prng.key(0),
                       checkpoint_root=str(tmp_path / "ck"))
        rt = api.emulated_cluster(2)[0]
        with api.SamplingSession(chain, api.SamplerConfig(
                runtime=rt, backend="streamed"), device="cpu") as sess:
            with pytest.raises(ValueError, match="single-process local"):
                svc.submit(sess, n_samples=8, key=prng.key(0))


def test_lane_batches_in_stats(chain):
    with SamplingService(workers=1, device="cpu") as svc:
        svc.submit(chain, n_samples=64, key=prng.key(23),
                   macro_batches=4).result(timeout=300)
        assert sum(svc.stats()["lane_batches"].values()) == 4


# ---------------------------------------------------------------------------
# worker processes (on the CPU)
# ---------------------------------------------------------------------------

def test_fleet_lanes_kill_and_drop_bitidentical(chain):
    """Two worker processes behind fleet lanes: a lane killed mid-job
    (its process killed too, its claim requeued) and a dropped result
    (a lane fault: the batch recomputed, the worker respawned); the
    blocks equal the single-lane run and the JAX package's service."""
    key = prng.key(42)
    n, k = 48, 4
    ref = _baseline(chain, n, key, k)
    np.testing.assert_array_equal(ref, _reference(chain, n, 42, k))
    pool = transport.WorkerPool(device="cpu")
    drop = DropResult(batch_ids={3})
    pool.injectors.append(drop)
    with SamplingService(workers=2, pool=pool, straggler_k=None) as svc:
        kill = KillLane(svc, on_batch=1)
        svc.batch_hook = kill
        h = svc.submit(chain, n_samples=n, key=key, macro_batches=k)
        out = h.result(timeout=300)
        st = svc.stats()
        stats = h.stats
    pool.close()
    np.testing.assert_array_equal(out, ref)
    assert kill.victim is not None and drop.fired
    assert st["transport"]["lane_faults"] >= 1
    assert st["transport"]["spawned"] >= 3        # 2 lanes + a respawn
    assert h.progress["requeues"] >= 2 and h.progress["done"] == k
    assert st["faults"]["transport"] >= 1
    assert sum(st["lane_batches"].values()) == k
    for b, s in stats.items():                    # the workers' own walks
        assert s["segments"] == 1 and s["transport_worker"].startswith(
            "lane-")
        assert s["launches"] == {}                # plain cells on the CPU


def test_remote_runtime_persistent_worker_reuse(chain):
    """``runtime="remote"`` keeps one worker across submits; the one-shot
    worker gives the same bits."""
    key = prng.key(31)
    with api.SamplingSession(chain, api.SamplerConfig(runtime="remote"),
                             device="cpu") as s:
        a = s.sample(16, key)
        pid = s.runtime.worker.pid
        b = s.sample(16, prng.key(32))
        assert s.runtime.worker.pid == pid
        io_c = s.runtime.io_counters()
        assert io_c["persistent_worker"] is True
        assert io_c["dispatches"] == 2
        assert s.runtime.worker.batches == 2
    assert not s.runtime.io_counters()["persistent_worker"]   # reaped
    rt = api.RemoteRuntime(persistent=False, device="cpu")
    with api.SamplingSession(chain, api.SamplerConfig(runtime=rt),
                             device="cpu") as s:
        np.testing.assert_array_equal(s.sample(16, key), a)
    np.testing.assert_array_equal(a, _baseline(chain, 16, key, 1))
    with japi.SamplingSession(chain) as js:
        np.testing.assert_array_equal(
            a, np.asarray(js.sample(16, jax.random.key(31))))
    assert not np.array_equal(a, b)


def test_worker_without_a_card_fails_its_first_call(chain, tmp_path):
    """A worker started for the card (no ``--device``) on a machine with
    no GPU fails its first call with the error: it never walks on the CPU
    instead.  The failure is a job error, not a lane fault."""
    env = {**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""}
    pool = transport.WorkerPool(env=env)
    with SamplingService(workers=1, pool=pool) as svc:
        h = svc.submit(chain, n_samples=8, key=prng.key(0))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            h.result(timeout=300)
        assert h.status() == "failed"
        assert svc.stats()["transport"]["lane_faults"] == 0
    pool.close()
