"""The port's job service (``repro_torch.api.service``) against the JAX
package's (``repro.api.service``): the counterparts of
``tests/test_service.py``'s cases that are not marked slow.

The chain is the JAX package's (10, 6, 3) linear fixture, in an fp64
store the JAX package wrote and carried over as a port MPS
(``convert.mps_from_arrays``).  Every block is compared exactly: with the
port's plain walk on its batch key (``batch_key``: the job key for a
one-batch job, ``fold_in(key, b)`` for batch b of k), and where the JAX
package's service runs the same job, with its blocks.
"""
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.api.service import batch_key as j_batch_key  # noqa: E402
from repro.data.gamma_store import GammaStore as JStore  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api.service import (  # noqa: E402
    JobCancelled, batch_checkpoint_dir, batch_key)
from repro_torch.convert import mps_from_arrays  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import sampler as S  # noqa: E402
from repro_torch.data.gamma_store import GammaStore  # noqa: E402
from repro_torch.runtime.elastic import WorkQueue  # noqa: E402

CFG = dict(segment_len=4, kernels="torch")


@pytest.fixture(scope="module")
def chain(tmp_path_factory, linear_mps_10x6):
    root = str(tmp_path_factory.mktemp("svc_gamma"))
    with JStore(root, storage_dtype=jnp.float64,
                compute_dtype=jnp.float64) as store:
        store.write_mps(linear_mps_10x6)
    mps = mps_from_arrays(linear_mps_10x6.gammas, linear_mps_10x6.lambdas,
                          device="cpu")
    return root, mps


def _svc(**kw):
    return api.SamplingService(device="cpu", **kw)


def _ref(mps, n, key):
    return S.sample(mps, n, key, S.SamplerConfig(kernels="torch")).numpy()


def _cfg(**kw):
    return api.SamplerConfig(**{**CFG, **kw})


def test_batch_key_is_the_reference_schedule():
    for k, b in ((1, 0), (4, 0), (4, 3)):
        want = np.asarray(jax.random.key_data(
            j_batch_key(jax.random.key(7), b, k)))
        assert batch_key(prng.key(7), b, k).tolist() == want.tolist()


def test_single_batch_job_is_the_one_shot_call(chain):
    root, mps = chain
    key = prng.key(3)
    ref = _ref(mps, 24, key)
    with _svc() as svc:
        h = svc.submit(root, _cfg(), n_samples=24, key=key)
        np.testing.assert_array_equal(h.result(), ref)
        assert h.status() == "done"
        assert h.progress["done"] == 1 and h.progress["total"] == 1
    with api.SamplingSession(root, _cfg(), device="cpu") as sess:
        np.testing.assert_array_equal(sess.sample(24, key), ref)
    with japi.SamplingSession(root, japi.SamplerConfig(segment_len=4)) as js:
        np.testing.assert_array_equal(
            np.asarray(js.sample(24, jax.random.key(3))), ref)


@pytest.mark.parametrize("backend", ["inmem", "streamed"])
def test_stream_blocks_bitidentical_per_seed_seq(chain, backend):
    """A job's streamed blocks, in batch order, each once, equal the
    one-shot walks on their batch keys and the JAX package's job."""
    root, mps = chain
    key = prng.key(7)
    n, k = 32, 4
    src = mps if backend == "inmem" else root
    refs = [_ref(mps, n // k, batch_key(key, b, k)) for b in range(k)]
    # no straggler reclaim: a loaded host could make one, and its duplicate
    # claim would count (its result is discarded, the blocks stay equal)
    with _svc(workers=2, straggler_k=None) as svc:
        h = svc.submit(src, _cfg(backend=backend), n_samples=n, key=key,
                       macro_batches=k)
        seen = []
        for b, block in h.stream(timeout=300):
            seen.append(b)
            np.testing.assert_array_equal(block, refs[b])
        assert seen == list(range(k))
        np.testing.assert_array_equal(h.result(), np.concatenate(refs))
        assert h.progress["claims"] == k and h.progress["requeues"] == 0
    with japi.SamplingService(workers=2) as jsvc:
        jh = jsvc.submit(root, japi.SamplerConfig(segment_len=4),
                         n_samples=n, key=jax.random.key(7), macro_batches=k)
        np.testing.assert_array_equal(np.asarray(jh.result(timeout=300)),
                                      np.concatenate(refs))


def test_skip_batches_resume_by_id(chain):
    root, mps = chain
    key = prng.key(11)
    with _svc() as svc:
        h = svc.submit(root, _cfg(), n_samples=24, key=key, macro_batches=3,
                       skip_batches=[1])
        got = dict(h.stream(timeout=300))
    assert sorted(got) == [0, 2]
    for b in got:
        np.testing.assert_array_equal(got[b],
                                      _ref(mps, 8, batch_key(key, b, 3)))


def test_cancel_pending_job_and_elastic_scale_up(chain):
    root, _ = chain
    key = prng.key(13)
    with _svc(workers=0) as svc:
        h = svc.submit(root, _cfg(), n_samples=16, key=key, macro_batches=2)
        assert h.status() == "pending"
        assert h.cancel()
        assert h.status() == "cancelled"
        with pytest.raises(JobCancelled):
            h.result(timeout=30)
        h2 = svc.submit(root, _cfg(), n_samples=8, key=key)
        svc.add_worker()
        assert h2.result(timeout=300).shape == (8, 10)


def test_cancel_mid_job_stops_remaining_batches(chain):
    root, mps = chain
    key = prng.key(17)
    with _svc(workers=0) as svc:
        h = None

        def hook(job, b, worker):
            if b == 1:
                h.cancel()

        svc.batch_hook = hook
        h = svc.submit(root, _cfg(), n_samples=32, key=key, macro_batches=4)
        svc.add_worker()
        stream = h.stream(timeout=300)
        b0, block0 = next(stream)
        assert b0 == 0
        np.testing.assert_array_equal(block0,
                                      _ref(mps, 8, batch_key(key, 0, 4)))
        with pytest.raises(JobCancelled):
            list(stream)
        assert h.status() == "cancelled"
        assert h.progress["blocks"] == 1


def test_purge_drops_finished_jobs_but_handles_keep_answering(chain):
    root, mps = chain
    key = prng.key(53)
    ref = _ref(mps, 8, key)
    with _svc() as svc:
        h = svc.submit(root, _cfg(), n_samples=8, key=key)
        np.testing.assert_array_equal(h.result(timeout=300), ref)
        assert svc.purge() == 1
        assert all(n == 0 for n in svc.stats()["jobs"].values())
        assert h.status() == "done"
        np.testing.assert_array_equal(h.result(), ref)


def test_multihost_runtime_rejects_multi_lane_service(chain):
    root, _ = chain
    rt = api.emulated_cluster(2)[0]
    with api.SamplingSession(root, _cfg(runtime=rt, backend="streamed"),
                             device="cpu") as sess:
        with _svc(workers=2) as svc:
            with pytest.raises(ValueError, match="single-lane"):
                svc.submit(sess, n_samples=8, key=prng.key(0))


def test_multirank_mesh_rejects_multi_lane_service(chain):
    """A mesh over several ranks: every rank must walk the batches in one
    order, so its jobs run on one lane (checked at submit)."""
    from types import SimpleNamespace
    root, mps = chain
    mesh = SimpleNamespace(shape={"data": 2, "model": 1},
                           axis_names=("data", "model"),
                           device=torch.device("cpu"))
    with api.SamplingSession(mps, _cfg(scheme="dp"), device="cpu",
                             mesh=mesh) as sess:
        with _svc(workers=2) as svc:
            with pytest.raises(ValueError, match="single-lane"):
                svc.submit(sess, n_samples=8, key=prng.key(0))


def test_stream_timeout_is_a_real_deadline(chain):
    root, _ = chain
    with _svc(workers=0) as svc:
        h = svc.submit(root, _cfg(), n_samples=8, key=prng.key(0))

        def churn():
            for _ in range(50):
                with svc._cond:
                    svc._cond.notify_all()
                time.sleep(0.01)

        t = threading.Thread(target=churn)
        t.start()
        with pytest.raises(TimeoutError):
            h.result(timeout=0.2)
        t.join()


def test_removed_worker_name_can_be_revived(chain):
    root, _ = chain
    key = prng.key(59)
    with _svc(workers=0) as svc:
        svc.add_worker("gpu-lane")
        h1 = svc.submit(root, _cfg(), n_samples=8, key=key)
        h1.result(timeout=300)
        svc.remove_worker("gpu-lane")
        svc._threads["gpu-lane"].join(timeout=60)
        svc.add_worker("gpu-lane")
        h2 = svc.submit(root, _cfg(), n_samples=8, key=key)
        np.testing.assert_array_equal(h2.result(timeout=300), h1.result())


def test_single_batch_job_honours_checkpoint_root(chain, tmp_path):
    root, mps = chain
    key = prng.key(61)
    ref = _ref(mps, 16, key)
    cfg = _cfg(checkpoint_every=1)
    ck = batch_checkpoint_dir(str(tmp_path), 0)
    os.makedirs(ck, exist_ok=True)
    with api.SamplingSession(root, cfg, device="cpu") as sess:
        part = sess.sample(16, key, checkpoint_dir=ck, stop_after_segments=2)
        np.testing.assert_array_equal(part, ref[:, :8])
    with _svc() as svc:
        h = svc.submit(root, cfg, n_samples=16, key=key,
                       checkpoint_root=str(tmp_path))
        out = h.result(timeout=300)
        assert h.stats[0]["segments"] == 1       # resumed at site 8
    np.testing.assert_array_equal(out, ref)
    assert not os.path.exists(ck)
    with _svc(workers=0) as svc:
        with pytest.raises(ValueError, match="checkpoint_root"):
            svc.submit(root, cfg, n_samples=16, key=key,
                       checkpoint_root=str(tmp_path), resume=True)


def test_store_handles_with_different_dtypes_do_not_coalesce(chain):
    root, _ = chain
    key = prng.key(67)
    with GammaStore(root, torch.float64, torch.float64) as s64, \
            GammaStore(root, torch.float64, torch.float32) as s32, \
            _svc() as svc:
        svc.submit(s64, _cfg(), n_samples=8, key=key).result(timeout=300)
        svc.submit(s32, _cfg(), n_samples=8, key=key).result(timeout=300)
        assert svc.stats()["sessions"] == 2


def test_priority_ordering(chain):
    root, _ = chain
    key = prng.key(19)
    order = []
    with _svc(workers=0) as svc:
        svc.batch_hook = lambda job, b, w: order.append(job.job_id)
        lo = svc.submit(root, _cfg(), n_samples=8, key=key, priority=0)
        hi = svc.submit(root, _cfg(), n_samples=8, key=key, priority=5)
        svc.add_worker()
        lo.result(timeout=300), hi.result(timeout=300)
    assert order == [hi.job_id, lo.job_id]


def test_failed_job_reraises_original_error(chain):
    root, _ = chain
    with api.SamplingSession(root, _cfg(), device="cpu") as sess:
        with pytest.raises(ValueError, match="checkpoint_dir"):
            sess.sample(8, prng.key(0), resume=True)


def test_submit_validation(chain):
    root, _ = chain
    key = prng.key(0)
    with _svc(workers=0) as svc:
        with pytest.raises(ValueError, match="divide"):
            svc.submit(root, _cfg(), n_samples=10, key=key, macro_batches=3)
        with pytest.raises(ValueError, match="skip_batches"):
            svc.submit(root, _cfg(), n_samples=8, key=key, macro_batches=2,
                       skip_batches=[2])
        with pytest.raises(ValueError, match="checkpoint_root"):
            svc.submit(root, _cfg(), n_samples=8, key=key, macro_batches=2,
                       resume=True)
        with pytest.raises(ValueError, match="needs a mesh"):
            svc.submit(root, _cfg(scheme="dp"), n_samples=8, key=key)


@pytest.mark.parametrize("backend", ["inmem", "streamed"])
def test_worker_kill_requeues_and_samples_identical(chain, backend):
    root, mps = chain
    key = prng.key(23)
    n, k = 32, 4
    src = mps if backend == "inmem" else root
    refs = [_ref(mps, n // k, batch_key(key, b, k)) for b in range(k)]
    killed = []
    with _svc(workers=2) as svc:
        def hook(job, b, worker):
            if b == 2 and not killed:
                killed.append(worker)
                svc.remove_worker(worker)

        svc.batch_hook = hook
        h = svc.submit(src, _cfg(backend=backend), n_samples=n, key=key,
                       macro_batches=k)
        out = h.result(timeout=300)
    assert killed
    np.testing.assert_array_equal(out, np.concatenate(refs))
    assert h.progress["requeues"] >= 1 and h.progress["done"] == k


def test_late_completion_from_removed_worker_is_discarded():
    q = WorkQueue(2)
    assert q.claim("a", now=0.0) == 0
    q.remove_worker("a")
    assert not q.complete(0, worker="a")
    assert q.claim("b", now=1.0) == 0
    assert q.complete(0, worker="b")
    assert q.stats()["requeues"] == 1


def test_same_cell_jobs_coalesce_onto_one_session(chain):
    root, mps = chain
    key = prng.key(29)
    ref = _ref(mps, 16, key)
    with _svc() as svc:
        h1 = svc.submit(root, _cfg(), n_samples=16, key=key)
        h2 = svc.submit(root, _cfg(), n_samples=16, key=key)
        np.testing.assert_array_equal(h1.result(timeout=300), ref)
        np.testing.assert_array_equal(h2.result(timeout=300), ref)
        st = svc.stats()
        assert st["sessions"] == 1 and st["coalesced_jobs"] == 1
        (sess,) = svc._sessions.values()
        assert len(sess._engines) == 1
    with api.SamplingSession(root, _cfg(), device="cpu") as sess:
        assert sess.plan(16).cell == ("streamed", "local", "seq", "linear",
                                      "torch")


def test_streamed_engine_cached_per_engine_identity(chain):
    root, mps = chain
    key = prng.key(31)
    with api.SamplingSession(root, _cfg(), device="cpu") as sess:
        sess.sample(16, key)
        sess.sample(16, prng.key(99))
        out8 = sess.sample(8, key)
        assert len(sess._engines) == 1
    np.testing.assert_array_equal(out8, _ref(mps, 8, key))


def test_multibatch_job_never_falls_back_to_config_checkpoint_dir(
        chain, tmp_path):
    root, mps = chain
    key = prng.key(71)
    cfg = _cfg(checkpoint_dir=str(tmp_path), checkpoint_every=1)
    with _svc() as svc:
        h = svc.submit(root, cfg, n_samples=16, key=key, macro_batches=2)
        got = dict(h.stream(timeout=300))
    for b in range(2):
        np.testing.assert_array_equal(got[b],
                                      _ref(mps, 8, batch_key(key, b, 2)))
    assert os.listdir(str(tmp_path)) == []


def test_add_worker_rejected_while_multiprocess_job_active(chain):
    root, _ = chain
    rt = api.emulated_cluster(2)[0]
    claimed, release = threading.Event(), threading.Event()
    with api.SamplingSession(root, _cfg(runtime=rt, backend="streamed"),
                             device="cpu") as sess:
        with _svc(workers=0) as svc:
            def hook(job, b, worker):
                claimed.set()
                release.wait(timeout=60)

            svc.batch_hook = hook
            h = svc.submit(sess, n_samples=8, key=prng.key(0))
            svc.add_worker()
            assert claimed.wait(timeout=60)
            with pytest.raises(ValueError, match="multi-process"):
                svc.add_worker()
            h.cancel()
            release.set()


def test_pipelined_batches_bitidentical_and_prefetch_reused(chain):
    root, mps = chain
    key = prng.key(37)
    refs = [_ref(mps, 8, batch_key(key, b, 3)) for b in range(3)]
    with _svc() as svc:
        h = svc.submit(root, _cfg(), n_samples=24, key=key, macro_batches=3)
        got = dict(h.stream(timeout=300))
        stats = h.stats
    for b in range(3):
        np.testing.assert_array_equal(got[b], refs[b])
    assert all(s["max_live_segments"] <= 2 for s in stats.values())
    # batches 1 and 2 opened on the first segment fetched behind the
    # previous batch's last one: no wait for a read that was in flight
    assert stats[1]["max_live_segments"] >= 1


def test_multihost_pipelined_job_bitidentical(chain):
    """Gang scheduling on the emulated 2-process cluster: each member runs
    the same 2-batch job on a one-lane service; batch 1's first segment is
    broadcast behind batch 0's last, and every member gets the blocks of
    the local schedule."""
    root, mps = chain
    key = prng.key(47)
    refs = [_ref(mps, 8, batch_key(key, b, 2)) for b in range(2)]
    outs, errs = {}, []

    def run(rt):
        try:
            with api.SamplingSession(root, _cfg(runtime=rt,
                                                backend="streamed"),
                                     device="cpu") as sess:
                with _svc() as svc:
                    h = svc.submit(sess, n_samples=16, key=key,
                                   macro_batches=2)
                    outs[rt.process_index] = dict(h.stream(timeout=300))
        except Exception as e:          # noqa: BLE001 — asserted below
            errs.append(repr(e))

    threads = [threading.Thread(target=run, args=(rt,))
               for rt in api.emulated_cluster(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs, errs
    for p in (0, 1):
        for b in range(2):
            np.testing.assert_array_equal(outs[p][b], refs[b])


def test_run_queue_still_splits_work_across_sessions(chain):
    root, mps = chain
    key = prng.key(41)
    q = WorkQueue(4)
    with api.SamplingSession(root, _cfg(), device="cpu") as sess:
        out = sess.run_queue(q, 8, key, worker="w0")
    assert sorted(out) == [0, 1, 2, 3] and q.finished
    for b, blk in out.items():
        np.testing.assert_array_equal(blk,
                                      _ref(mps, 8, prng.fold_in(key, b)))


def test_remote_payload_carries_job_batch_unit(chain):
    root, mps = chain
    key = prng.key(43)
    refs = [_ref(mps, 8, batch_key(key, b, 2)) for b in range(2)]
    cfg = api.SamplerConfig(backend="remote", segment_len=4)
    with _svc() as svc:
        h = svc.submit(root, cfg, n_samples=16, key=key, macro_batches=2)
        got = dict(h.stream(timeout=300))
    for b in range(2):
        np.testing.assert_array_equal(got[b], refs[b])
    from repro_torch.api.remote import build_payload, execute_payload
    from repro_torch.api.service import JobBatch
    with GammaStore(root, torch.float64, torch.float64) as store:
        p = build_payload(cfg, store, 8, key, job=JobBatch(0, 1, 2))
        assert p["version"] == 2 and p["job"]["batch_id"] == 1
        np.testing.assert_array_equal(execute_payload(p, device="cpu"),
                                      refs[1])
        p1 = build_payload(cfg, store, 8, key)
        assert "job" not in p1
        np.testing.assert_array_equal(execute_payload(p1, device="cpu"),
                                      _ref(mps, 8, key))


def test_clamped_job_carries_log_prob_per_batch(chain):
    """``--clamp`` through the service: each batch's ``log_prob`` is its
    own walk's, in the batch's stats."""
    root, mps = chain
    key = prng.key(45)
    cfg = _cfg(clamp={1: 0, 4: 2})
    with _svc(workers=2) as svc:
        h = svc.submit(root, cfg, n_samples=16, key=key, macro_batches=2)
        got = dict(h.stream(timeout=300))
        stats = h.stats
    with api.SamplingSession(root, cfg, device="cpu") as sess:
        for b in range(2):
            want = sess.sample(8, batch_key(key, b, 2))
            np.testing.assert_array_equal(got[b], want)
            np.testing.assert_array_equal(stats[b]["log_prob"],
                                          sess.stats["log_prob"])


def test_workqueue_requeued_before_fresh_and_stats():
    q = WorkQueue(5)
    assert q.claim("a", now=0.0) == 0
    assert q.claim("a", now=0.0) == 1
    assert q.claim("b", now=0.0) == 2
    q.complete(0)
    q.remove_worker("a")
    assert q.stats() == {"total": 5, "done": 1, "claimed": 1, "requeued": 1,
                         "pending": 4, "claims": 3, "requeues": 1,
                         "workers": 1}
    assert q.claim("c", now=1.0) == 1
    assert q.claim("c", now=1.0) == 3
