"""The port's cluster runtimes (``repro_torch.api.runtime``,
``repro_torch.api.remote``) against the JAX package's (``repro.api``).

* The registry names and resolution.
* The segment wire format: ``payload_to_bytes`` / ``payload_from_bytes``
  round trips (bf16 and fp64 stores, the error frame, the generic dict
  frame), read across packages both ways, and the CRC that rejects a
  payload corrupted on the wire.
* The §3.1 broadcast plane: ``emulated_cluster(2)`` and ``(3)`` streamed
  walks (one thread per member) equal the local streamed walk and the JAX
  package's emulated cluster on the same store, with the root alone
  reading it; ``torchrun`` with 2 gloo ranks of ``launch.sample --runtime
  multihost --stream --service`` runs a pipelined 2-batch job whose second
  batch resumes from an unclean stop, and equals them too.
* The v2 job-batch payload across packages: a payload the JAX package
  built runs in the port and gives the JAX package's samples, and the
  reverse.
Samples are compared exactly (the walks draw the same uniforms and
compare the same CDFs: fp64 identity stores, bf16 stores decoded to fp64).
"""
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.api import remote as jremote  # noqa: E402
from repro.api import runtime as jruntime  # noqa: E402
from repro.api.service import JobBatch as JJobBatch  # noqa: E402
from repro.data.gamma_store import GammaStore as JStore  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import remote, runtime as RT  # noqa: E402
from repro_torch.api.service import (  # noqa: E402
    JobBatch, batch_checkpoint_dir)
from repro_torch.core import prng  # noqa: E402
from repro_torch.data import gamma_store as GS  # noqa: E402
from repro_torch.data.gamma_store import GammaStore  # noqa: E402
from repro_torch.runtime.faults import CorruptSegment  # noqa: E402

N = 16
DTYPES = {"fp64": ((jnp.float64, jnp.float64),
                   (torch.float64, torch.float64)),
          "bf16": ((jnp.bfloat16, jnp.float64),
                   (torch.bfloat16, torch.float64))}


@pytest.fixture(scope="module")
def stores(tmp_path_factory, linear_mps_10x6):
    """The (10, 6, 3) chain in stores the JAX package wrote."""
    out = {}
    for name, ((jsd, jcd), _) in DTYPES.items():
        root = str(tmp_path_factory.mktemp(f"rt_{name}"))
        with JStore(root, storage_dtype=jsd, compute_dtype=jcd) as st:
            st.write_mps(linear_mps_10x6)
        out[name] = root
    return out


def _store(stores, name):
    sd, cd = DTYPES[name][1]
    return GammaStore(stores[name], sd, cd)


def _local_walk(stores, name, key, seg=4):
    with api.SamplingSession(_store(stores, name), api.SamplerConfig(
            segment_len=seg, kernels="torch"), device="cpu") as s:
        return s.sample(N, key)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def test_registry_matches_the_reference():
    assert api.available_runtimes() == japi.available_runtimes() == [
        "local", "multihost", "remote"]
    assert isinstance(api.resolve_runtime("auto"), api.LocalRuntime)
    rt = api.emulated_cluster(2)[1]
    assert api.resolve_runtime(rt) is rt
    assert (rt.process_index, rt.process_count, rt.is_root) == (1, 2, False)
    with pytest.raises(ValueError, match="no runtime"):
        api.get_runtime("carrier-pigeon")
    with pytest.raises(TypeError):
        api.resolve_runtime(3)
    with pytest.raises(ValueError, match="≥ 2"):
        api.emulated_cluster(1)
    with pytest.raises(ValueError, match="≥ 2 processes"):
        api.get_runtime("multihost")            # one process, no job


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(DTYPES))
def test_payload_bytes_round_trip_across_packages(stores, name):
    """Bytes the port frames decode in the JAX package and the reverse,
    with the same Γ bytes, dtypes and checksum."""
    (jsd, jcd), _ = DTYPES[name]
    with _store(stores, name) as st, \
            JStore(stores[name], storage_dtype=jsd, compute_dtype=jcd) as js:
        mine = st.get_segment_raw(2, 3)
        theirs = js.get_segment_raw(2, 3)
        assert int(mine["crc"]) == int(theirs["crc"])
        back = RT.payload_from_bytes(RT.payload_to_bytes(mine))
        from_jax = RT.payload_from_bytes(jruntime.payload_to_bytes(theirs))
        to_jax = jruntime.payload_from_bytes(RT.payload_to_bytes(mine))
        for got in (back, from_jax):
            np.testing.assert_array_equal(got["gamma"], mine["gamma"])
            np.testing.assert_array_equal(got["lam"], mine["lam"])
            assert (got["start"], got["gshape"], got["two_byte"],
                    got["crc"]) == (2, (6, 6, 3), name == "bf16",
                                    int(mine["crc"]))
            assert (got["storage_dtype"], got["compute_dtype"]) == \
                DTYPES[name][1]
        np.testing.assert_array_equal(np.asarray(to_jax["gamma"]),
                                      np.asarray(theirs["gamma"]))
        assert np.dtype(to_jax["storage_dtype"]).name == \
            np.dtype(jsd).name
        g, lam = GS.decode_segment(from_jax)
        jg, jlam = GS.decode_segment(back)
        assert torch.equal(g, jg) and torch.equal(lam, jlam)


def test_error_frame_and_dict_frame(stores):
    err = {"start": 4, "error": "Γ site 5 rotted",
           "fault": {"kind": "corruption", "site": 5}}
    for to_bytes, from_bytes in (
            (RT.payload_to_bytes, RT.payload_from_bytes),
            (RT.payload_to_bytes, jruntime.payload_from_bytes),
            (jruntime.payload_to_bytes, RT.payload_from_bytes)):
        assert from_bytes(to_bytes(err)) == err
    d = {"env": np.arange(6.0).reshape(2, 3), "site": np.int64(7)}
    back = RT.dict_from_bytes(RT.dict_to_bytes(d))
    np.testing.assert_array_equal(back["env"], d["env"])
    assert int(back["site"]) == 7
    np.testing.assert_array_equal(
        jruntime.dict_from_bytes(RT.dict_to_bytes(d))["env"], d["env"])


def test_corrupt_wire_payload_rejected(stores):
    with _store(stores, "fp64") as st:
        payload = RT.payload_from_bytes(RT.payload_to_bytes(
            st.get_segment_raw(0, 2)))
    payload["lam"] = payload["lam"].copy()
    payload["lam"][0, 0] += 1.0
    with pytest.raises(CorruptSegment) as ei:
        GS.payload_on_device(payload, torch.device("cpu"))
    assert ei.value.fault.kind == "corruption" and ei.value.fault.site == 0


def test_payload_on_device_is_the_host_decode(stores):
    with _store(stores, "bf16") as st:
        payload = st.get_segment_raw(3, 4)
        seg = GS.payload_on_device(payload, torch.device("cpu"), chi=4)
        g, lam = st.get_segment(3, 4, prefetch_next_segment=False)
    assert torch.equal(seg["gammas"], g[:, :4, :4, :])
    assert torch.equal(seg["lambdas"], lam[:, :4])


@pytest.mark.parametrize("scheme", ["tp_single", "tp_double"])
@pytest.mark.parametrize("p2,rank", [(2, 0), (2, 1), (1, 0)])
def test_payload_tile_is_the_decoded_tile(stores, scheme, p2, rank):
    """A TP rank's walk takes only its tiles of each Γ from a payload or
    the store (``core.mps.site_tile``, sites counted from the chain's
    start): the tiles of the whole decode, χ-stage cut first."""
    from repro_torch.core import parallel as PP
    from repro_torch.core.mps import MPS

    with _store(stores, "bf16") as st:
        g, lam = st.get_segment(2, 4, prefetch_next_segment=False)
        want = PP.shard_chain(MPS(g[:, :4, :4].contiguous(), lam[:, :4]),
                              scheme, p2, rank)
        for seg in (GS.payload_on_device(st.get_segment_raw(2, 4),
                                         torch.device("cpu"), chi=4,
                                         tile=(scheme, p2, rank)),
                    st.get_segment_on_device(2, 4, "cpu", chi=4,
                                             prefetch_next_segment=False,
                                             tile=(scheme, p2, rank))):
            assert torch.equal(seg["gammas"], want.gammas)
            assert torch.equal(seg["lambdas"], want.lambdas)
            if scheme == "tp_double":
                assert torch.equal(seg["gammas_right"], want.gammas_right)
            else:
                assert seg["gammas_right"] is None


def test_cli_lines_leave_in_one_write(tmp_path, monkeypatch):
    """Every line the sampling CLI prints reaches stdout in one write,
    its newline included (ranks of a job share the pipe: a line written
    in parts can be torn by another rank's), the runtime counters' too."""
    import sys

    from repro_torch.launch import sample as cli

    class Pipe:
        def __init__(self):
            self.writes = []

        def write(self, text):
            self.writes.append(text)
            return len(text)

        def flush(self):
            pass

    pipe = Pipe()
    monkeypatch.setattr(sys, "stdout", pipe)
    cli.main(["--device", "cpu", "--sites", "4", "--chi", "4", "--d", "3",
              "--samples", "8", "--macro-batches", "2", "--out",
              str(tmp_path)])
    cli._say("runtime counters:", json.dumps({"broadcast_send_bytes": 1}))
    assert len(pipe.writes) > 5
    assert all(w.endswith("\n") for w in pipe.writes), pipe.writes
    assert pipe.writes[-1] == \
        'runtime counters: {"broadcast_send_bytes": 1}\n'
    lines = "".join(pipe.writes).splitlines()
    assert any(ln.startswith("kernel launches:") for ln in lines)


# ---------------------------------------------------------------------------
# the broadcast plane
# ---------------------------------------------------------------------------

def _drop_after(ckpt_dir: str, site: int) -> None:
    """What an unclean stop after ``site`` leaves of a walk that kept every
    boundary: the boundaries past it are gone (the sample blocks past it
    are written again by the resumed walk)."""
    import os
    for f in os.listdir(ckpt_dir):
        if f.startswith("site_") and f.endswith(".npz") and \
                int(f[len("site_"):-len(".npz")]) > site:
            os.remove(os.path.join(ckpt_dir, f))


def _run_members(members, make_session, n, key):
    outs, stats, errs = {}, {}, {}

    def run(rt):
        try:
            with make_session(rt) as sess:
                outs[rt.process_index] = sess.sample(n, key)
                stats[rt.process_index] = dict(sess.stats)
        except BaseException as e:      # noqa: BLE001 — asserted below
            errs[rt.process_index] = e

    threads = [threading.Thread(target=run, args=(rt,)) for rt in members]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "cluster run hung"
    return outs, stats, errs


@pytest.mark.parametrize("n_proc,name", [(2, "fp64"), (3, "bf16")])
def test_emulated_cluster_equals_local_and_reference(stores, n_proc, name):
    key = prng.key(5)
    want = _local_walk(stores, name, key)
    outs, stats, errs = _run_members(
        api.emulated_cluster(n_proc),
        lambda rt: api.SamplingSession(
            _store(stores, name), api.SamplerConfig(
                runtime=rt, backend="streamed", segment_len=4,
                kernels="torch"), device="cpu"), N, key)
    assert not errs, errs
    (jsd, jcd), _ = DTYPES[name]

    def jsession(rt):
        return japi.SamplingSession(
            JStore(stores[name], storage_dtype=jsd, compute_dtype=jcd),
            japi.SamplerConfig(runtime=rt, backend="streamed",
                               segment_len=4))
    jouts, _, jerrs = _run_members(japi.emulated_cluster(n_proc), jsession,
                                   N, jax.random.key(5))
    assert not jerrs, jerrs
    for p in range(n_proc):
        np.testing.assert_array_equal(outs[p], want)
        np.testing.assert_array_equal(outs[p], np.asarray(jouts[p]))
    assert stats[0]["io_bytes"] > 0                   # the root reads
    assert all(stats[p]["io_bytes"] == 0 for p in range(1, n_proc))
    assert stats[0]["broadcast_segments"] == 3        # 10 sites, 4 a segment
    assert stats[0]["broadcast_send_bytes"] == (n_proc - 1) * sum(
        stats[p]["broadcast_recv_bytes"] for p in range(1, 2))


def test_emulated_cluster_resume_agrees_on_the_oldest_boundary(stores,
                                                               tmp_path):
    """An unclean stop leaves the members at different boundaries: the
    resume agrees on the newest one both hold and gives the uninterrupted
    samples."""
    key = prng.key(9)
    want = _local_walk(stores, "fp64", key, seg=2)
    members = api.emulated_cluster(2)
    cks = {p: str(tmp_path / f"ck{p}") for p in (0, 1)}

    def session(rt):
        return api.SamplingSession(_store(stores, "fp64"), api.SamplerConfig(
            runtime=rt, backend="streamed", segment_len=2, kernels="torch",
            checkpoint_dir=cks[rt.process_index]), device="cpu")
    outs, _, errs = _run_members(members, session, N, key)
    assert not errs, errs
    for p, cut in ((0, 8), (1, 4)):
        _drop_after(cks[p], cut)

    resumed, stats, errs = {}, {}, {}

    def resume(rt):
        try:
            with session(rt) as sess:
                resumed[rt.process_index] = sess.sample(N, key, resume=True)
                stats[rt.process_index] = dict(sess.stats)
        except BaseException as e:      # noqa: BLE001
            errs[rt.process_index] = e
    threads = [threading.Thread(target=resume, args=(rt,)) for rt in members]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs, errs
    for p in (0, 1):
        np.testing.assert_array_equal(outs[p], want)
        np.testing.assert_array_equal(resumed[p], want)
        assert stats[p]["segments"] == 3          # sites 4..10, 2 a segment


def test_multihost_gloo_ranks_equal_local_and_reference(stores, tmp_path):
    """``torchrun`` with 2 gloo ranks of ``launch.sample --runtime multihost
    --stream --service --macro-batches 2``: one pipelined job, so batch 1's
    first segment is broadcast on the prefetch thread while the ranks meet
    at batch 0's barrier.  Batch 1 resumes from an unclean stop that left
    the ranks at different boundaries (sites 8 and 4): they agree on site 4
    with ``allreduce_min`` while that broadcast may still run, drop it, and
    walk the 2 segments left.  Rank 0 alone reads; both batch files equal
    the local walks and the JAX package's."""
    import re
    import subprocess
    import sys

    out = tmp_path / "out"
    keys = [prng.fold_in(prng.key(1), b) for b in (0, 1)]   # --seed 0
    want = [_local_walk(stores, "bf16", k) for k in keys]
    for b in (0, 1):
        with japi.SamplingSession(stores["bf16"], japi.SamplerConfig(
                segment_len=4)) as js:
            np.testing.assert_array_equal(want[b], np.asarray(js.sample(
                N, jax.random.fold_in(jax.random.key(1), b))))
    # the unclean stop: batch 1's walk checkpointed its boundaries 4, 8
    # and 10 in each rank's directory, and the ranks stopped after 8 and 4
    for rank, cut in ((0, 8), (1, 4)):
        ck = batch_checkpoint_dir(str(out / f"chain_ckpt_rank{rank}"), 1)
        with api.SamplingSession(_store(stores, "bf16"), api.SamplerConfig(
                backend="streamed", segment_len=4, kernels="torch"),
                device="cpu") as s:
            s.sample(N, keys[1], checkpoint_dir=ck)
        _drop_after(ck, cut)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         "--nproc-per-node=2", f"--master-port={_free_port()}",
         "-m", "repro_torch.launch.sample", "--device", "cpu",
         "--kernels", "torch", "--runtime", "multihost", "--stream",
         "--store", stores["bf16"], "--scheme", "seq", "--segment-len",
         "4", "--samples", str(2 * N), "--macro-batches", "2", "--service",
         "--out", str(out)],
        env=_cli_env(), capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    for b in (0, 1):
        np.testing.assert_array_equal(
            np.load(out / f"batch_{b:05d}.npy"), want[b].astype(np.int8))
    lines = proc.stdout.splitlines()
    counters = [json.loads(ln.split(":", 1)[1]) for ln in lines
                if ln.startswith("runtime counters:")]
    # batch 0's 3 segments, the warm one batch 1 dropped, batch 1's last 2
    assert sorted(c["broadcast_segments"] for c in counters) == [6, 6]
    sent = sorted(c["broadcast_send_bytes"] for c in counters)
    got = sorted(c["broadcast_recv_bytes"] for c in counters)
    assert sent[0] == 0 and sent[1] == got[1] > 0 and got[0] == 0
    walk = [ln for ln in lines if ln.startswith("streaming stats:")]

    def stat(name):
        return sorted(int(re.search(rf"'{name}': (\d+)", ln).group(1))
                      for ln in walk)
    assert stat("segments") == [2, 2]         # batch 1 from site 4
    io = stat("io_bytes")                     # rank 0 alone reads
    assert io[0] == 0 and io[1] > 0


# ---------------------------------------------------------------------------
# the v2 payload across packages
# ---------------------------------------------------------------------------

def test_payload_runs_in_either_package(stores, linear_mps_10x6):
    key = prng.key(21)
    jkey = jax.random.key(21)
    cfg, jcfg = api.SamplerConfig(segment_len=4), japi.SamplerConfig(
        segment_len=4)
    with JStore(stores["bf16"], storage_dtype=jnp.bfloat16,
                compute_dtype=jnp.float64) as js, \
            _store(stores, "bf16") as st:
        for job in (None, (3, 1, 2)):
            jp = jremote.build_payload(
                jcfg, js, 8, jkey, job=job and JJobBatch(*job))
            tp = remote.build_payload(cfg, st, 8, key,
                                      job=job and JobBatch(*job))
            assert tp["key_data"] == jp["key_data"]
            assert json.loads(json.dumps(tp)) == tp         # plain JSON
            j_ref = np.asarray(jremote.execute_payload(jp))
            np.testing.assert_array_equal(
                remote.execute_payload(jp, device="cpu"), j_ref)
            np.testing.assert_array_equal(
                np.asarray(jremote.execute_payload(tp)), j_ref)
            np.testing.assert_array_equal(
                remote.execute_payload(tp, device="cpu"), j_ref)
    assert remote.config_from_dict(remote.config_to_dict(
        api.SamplerConfig(clamp={1: 0}, chi_profile=(6,) * 10,
                          compute_dtype=torch.bfloat16))) == \
        api.SamplerConfig(clamp={1: 0}, chi_profile=(6,) * 10,
                          compute_dtype=torch.bfloat16)


def test_local_runtime_submit_is_the_loopback(stores):
    """``backend="remote"`` on the local runtime: the payload runs here,
    one dispatch a batch, the service's job batch the unit."""
    key = prng.key(4)
    with api.SamplingSession(_store(stores, "fp64"), api.SamplerConfig(
            backend="remote", segment_len=4), device="cpu") as s:
        got = s.sample(N, key)
        assert s.stats["runtime_dispatches"] == 1
        assert s.stats["runtime_dispatch_bytes"] > 0
        np.testing.assert_array_equal(got, _local_walk(stores, "fp64", key))
        with api.SamplingService(workers=1) as svc:
            h = svc.submit(s, n_samples=2 * N, key=key, macro_batches=2)
            blocks = dict(h.stream(timeout=300))
    for b in (0, 1):
        np.testing.assert_array_equal(
            blocks[b], _local_walk(stores, "fp64", prng.fold_in(key, b)))


def test_clamp_rides_the_payload(stores):
    """A clamped config crosses the wire as the JAX package writes it and
    the worker walks the clamp (its log_prob stays the worker's)."""
    key = prng.key(6)
    cfg = api.SamplerConfig(segment_len=4, clamp={1: 2, 5: 0})
    with _store(stores, "fp64") as st:
        payload = remote.build_payload(cfg, st, N, key)
    assert payload["config"]["clamp"] == [[1, 2], [5, 0]]
    out, stats = remote.execute_payload_with_stats(payload, device="cpu")
    with api.SamplingSession(_store(stores, "fp64"), cfg,
                             device="cpu") as s:
        want = s.sample(N, key)
        np.testing.assert_allclose(stats["log_prob"], s.stats["log_prob"],
                                   rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(out, want)
    assert (out[:, 1] == 2).all() and (out[:, 5] == 0).all()
    jp = json.loads(json.dumps(payload))
    with JStore(stores["fp64"], storage_dtype=jnp.float64,
                compute_dtype=jnp.float64):
        np.testing.assert_array_equal(
            np.asarray(jremote.execute_payload(jp)), want)


def test_bytes_framing_is_a_view():
    """``payload_to_bytes`` hands out the frame's buffer (a writable view,
    no copy) so the gloo runtime broadcasts it as it is."""
    out = RT.payload_to_bytes({"start": 0, "error": "x"})
    assert out.flags.writeable and out.dtype == np.uint8
    assert np.load(io.BytesIO(out.tobytes()))["start"] == 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli_env() -> dict:
    """The CLI ranks' environment: the port on the path, unbuffered so the
    two ranks' lines reach the shared pipe whole."""
    import os
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    return dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1",
                PYTHONUNBUFFERED="1")


def test_cli_stream_on_two_ranks_and_multihost(tmp_path):
    """``torchrun`` with 2 gloo ranks and ``--stream``: each rank
    checkpoints under its own root (they shared one before, and the second
    rank's rename of a checkpoint failed), and ``--runtime multihost``
    (rank 0 reads and broadcasts) writes the same batch files."""
    import subprocess
    import sys

    env = _cli_env()
    outs = {}
    for name, extra in (("plain", []), ("multihost",
                                        ["--runtime", "multihost"])):
        out = tmp_path / name
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             "--nproc-per-node=2", f"--master-port={_free_port()}",
             "-m", "repro_torch.launch.sample", "--device", "cpu",
             "--sites", "6", "--chi", "8", "--samples", "64",
             "--macro-batches", "2", "--stream", "--segment-len", "2",
             "--out", str(out), *extra],
            env=env, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
        outs[name] = [np.load(out / f"batch_{b:05d}.npy") for b in (0, 1)]
        roots = sorted(p for p in out.iterdir()
                       if p.name.startswith("chain_ckpt"))
        assert [p.name for p in roots] == ["chain_ckpt_rank0",
                                           "chain_ckpt_rank1"]
        assert all(list(p.iterdir()) == [] for p in roots)   # batches out
        if extra:
            counters = [json.loads(ln.split(":", 1)[1]) for ln in
                        proc.stdout.splitlines()
                        if ln.startswith("runtime counters:")]
            sent = sorted(c["broadcast_send_bytes"] for c in counters)
            got = sorted(c["broadcast_recv_bytes"] for c in counters)
            assert sent[0] == 0 and sent[1] == got[1] > 0 and got[0] == 0
    for b in (0, 1):
        np.testing.assert_array_equal(outs["multihost"][b], outs["plain"][b])
