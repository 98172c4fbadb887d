"""The port's sharded data plane (``repro_torch.shard``, the engine's
``shard=`` walk, the runtimes' point-to-point plane, two-data-axis meshes)
against the JAX package's (``repro.shard``, ``repro.engine``,
``repro.api.runtime``) on stores the JAX package wrote.

* The ownership algebra: ``ShardMap`` and ``chain_segments`` equal the JAX
  package's over a sweep; the invariant the JAX package's property test
  states too broadly (runs of owned sites ≤ block) is held where it is
  true, with more than one host.
* The sharded store: a foreign read raises ``ShardViolation`` before the
  file is opened, prefetch of a foreign site is advisory, ``meta``
  redirects, and a materialized slice (hard links and the manifest) gives
  the JAX package's digest of the whole store.
* The codecs: handoffs and sample blocks cross between the packages.
* Sharded walks on emulated clusters: 2 and 4 hosts, block 1 and 2, fixed
  χ, dynamic χ and clamped, against the JAX package's sharded walk on the
  same store and seed: samples equal, the final env and ``log_scale``
  (the last owner's checkpoint at site M) within ``rtol=1e-12,
  atol=1e-14``, ``log_prob`` equal on every process; each host reads only
  the sites it owns.
* Resume at the agreed boundary, the refusals (``stop_after_segments``, a
  χ stage that splits a block) and the plan's checks, the remote payload
  carrying ``shard``, and ``shard_wire_bytes`` against the JAX package's.
* The point-to-point plane on the emulated fabric and on 2 gloo ranks
  (send, recv, all-gather, and a sharded walk equal to the local one), and
  a ("pod", "data", "model") mesh of 4 gloo ranks against the JAX
  package's dp walk on the same mesh (4 forced host devices).
"""
import json
import os
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as japi  # noqa: E402
from repro.api import runtime as JRT  # noqa: E402
from repro.checkpoint import sampler_state as JCK  # noqa: E402
from repro.core import perfmodel as JPM  # noqa: E402
from repro.data.gamma_store import GammaStore as JStore  # noqa: E402
from repro.shard import ShardMap as JShardMap  # noqa: E402
from repro.shard import ShardedGammaStore as JShardedStore  # noqa: E402
from repro.shard import chain_segments as j_chain_segments  # noqa: E402
from repro.shard import walk as JSW  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.api import remote  # noqa: E402
from repro_torch.api import runtime as RT  # noqa: E402
from repro_torch.checkpoint import sampler_state as CK  # noqa: E402
from repro_torch.core import perfmodel as PM  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.data.gamma_store import GammaStore  # noqa: E402
from repro_torch.shard import (ShardMap, ShardViolation,  # noqa: E402
                               ShardedGammaStore, chain_segments,
                               materialize_shard)
from repro_torch.shard import walk as SW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-12, atol=1e-14)
N = 16
F64 = (torch.float64, torch.float64)
PROFILE = (4, 4, 6, 6, 6, 6, 6, 6, 4, 4)
CLAMP = {1: 0, 6: 2}


@pytest.fixture(scope="module")
def chain(tmp_path_factory, linear_mps_10x6):
    """The (10, 6, 3) chain in an fp64 store the JAX package wrote, with
    its digest manifest."""
    root = str(tmp_path_factory.mktemp("shard_gamma"))
    with JStore(root, storage_dtype=jnp.float64,
                compute_dtype=jnp.float64) as st:
        st.write_mps(linear_mps_10x6)
        st.write_digest_manifest()
    return root


def _local(root, key, **fields):
    with api.SamplingSession(GammaStore(root, *F64), api.SamplerConfig(
            backend="streamed", kernels="torch", **fields),
            device="cpu") as s:
        out = s.sample(N, key)
        return out, dict(s.stats)


def _run_cluster(runtimes, make_session, n, key, resume=False):
    """One session per member, one thread each; (outs, stats, errs)."""
    outs, stats, errs = {}, {}, {}

    def run(rt):
        try:
            with make_session(rt) as s:
                outs[rt.process_index] = s.sample(n, key, resume=resume)
                stats[rt.process_index] = dict(s.stats)
        except BaseException as e:      # noqa: BLE001 — asserted below
            errs[rt.process_index] = e

    threads = [threading.Thread(target=run, args=(rt,), daemon=True)
               for rt in runtimes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "cluster run hung"
    return outs, stats, errs


def _port_cluster(root, hosts, key, ckpt=None, resume=False, **fields):
    def make(rt):
        extra = {} if ckpt is None else dict(
            checkpoint_dir=os.path.join(ckpt, f"h{rt.process_index}"),
            checkpoint_every=1)
        return api.SamplingSession(
            GammaStore(root, *F64), api.SamplerConfig(
                runtime=rt, backend="streamed", kernels="torch",
                **fields, **extra), device="cpu")
    outs, stats, errs = _run_cluster(api.emulated_cluster(hosts), make, N,
                                     key, resume)
    assert not errs, errs
    return outs, stats


def _jax_cluster(root, hosts, key, ckpt=None, **fields):
    def make(rt):
        extra = {} if ckpt is None else dict(
            checkpoint_dir=os.path.join(ckpt, f"h{rt.process_index}"),
            checkpoint_every=1)
        return japi.SamplingSession(JStore(
            root, storage_dtype=jnp.float64, compute_dtype=jnp.float64),
            japi.SamplerConfig(
            runtime=rt, backend="streamed", kernels="xla", **fields,
            **extra))
    outs, stats, errs = _run_cluster(japi.emulated_cluster(hosts), make, N,
                                     key)
    assert not errs, errs
    return outs, stats


# ---------------------------------------------------------------------------
# the ownership algebra
# ---------------------------------------------------------------------------

SWEEP = [(m, h, b) for m in (1, 2, 7, 10, 16) for h in (1, 2, 3, 4)
         for b in (1, 2, 3)]


@pytest.mark.parametrize("n_sites,hosts,block", SWEEP,
                         ids=[f"M{m}-H{h}-b{b}" for m, h, b in SWEEP])
def test_shardmap_matches_reference(n_sites, hosts, block):
    ours, ref = ShardMap(n_sites, hosts, block), JShardMap(n_sites, hosts,
                                                           block)
    assert [ours.owner(i) for i in range(n_sites)] == \
        [ref.owner(i) for i in range(n_sites)]
    for h in range(hosts):
        assert ours.owned_sites(h) == ref.owned_sites(h)
    assert ours.n_blocks == ref.n_blocks
    # every site has exactly one owner
    owned = sorted(i for h in range(hosts) for i in ours.owned_sites(h))
    assert owned == list(range(n_sites))
    if hosts > 1:
        # runs of consecutive owned sites are at most a block long (with
        # one host the whole chain is one run)
        for h in range(hosts):
            run = 0
            for i in range(n_sites):
                run = run + 1 if ours.owner(i) == h else 0
                assert run <= block
    for seg_len in (1, 2, 3):
        sched = chain_segments(n_sites, seg_len)
        assert sched == j_chain_segments(n_sites, seg_len)
        try:
            want = ref.handoffs(sched)
        except ValueError as e:
            with pytest.raises(ValueError, match="straddles"):
                ours.handoffs(sched)
            assert "straddles" in str(e)
            continue
        got = ours.handoffs(sched)
        assert got == want
        assert [b for b, _, _ in got] == sorted({b for b, _, _ in got})


def test_chain_segments_respects_stages():
    stages = [(0, 3, 4), (3, 10, 6)]
    assert chain_segments(10, 2, stages) == j_chain_segments(10, 2, stages)
    assert all(not (s0 < 3 < s1) for s0, s1, _ in chain_segments(10, 2,
                                                                  stages))


def test_shardmap_validation():
    for bad in ((0, 1, 1), (4, 0, 1), (4, 1, 0)):
        with pytest.raises(ValueError):
            ShardMap(*bad)
    sm = ShardMap(4, 2, 2)
    with pytest.raises(IndexError):
        sm.owner(4)
    with pytest.raises(ValueError, match="straddles"):
        sm.segment_owner(1, 3)


# ---------------------------------------------------------------------------
# the sharded store
# ---------------------------------------------------------------------------

def test_foreign_read_refused_before_the_file_opens(chain, tmp_path,
                                                    monkeypatch):
    sm = ShardMap(10, 2, 2)             # host 1 owns 2, 3, 6, 7
    with ShardedGammaStore(chain, sm, 1, *F64) as st:
        opened = []
        real_open = open

        def spy(path, *a, **kw):
            opened.append(str(path))
            return real_open(path, *a, **kw)
        monkeypatch.setattr("builtins.open", spy)
        with pytest.raises(ShardViolation, match="owned by host 0"):
            st.get_raw(0)
        with pytest.raises(ShardViolation):
            st.get_segment_raw(0, 2)
        monkeypatch.undo()
        assert not [p for p in opened if p.endswith(".npz")]
        assert st.payload_reads == 0
        st.prefetch(4)                   # foreign: advisory, nothing read
        st.prefetch_segment(4, 2)
        g, _ = st.get(2)
        assert st.payload_reads == 1
        assert tuple(g.shape) == (6, 6, 3)
        assert st.meta(0) == st.meta(2) == (6, 6, 3)   # redirected
        with pytest.raises(ShardViolation, match="write"):
            st.put(0, g, torch.ones(6))
    # a host that owns nothing cannot probe a shape
    with ShardedGammaStore(chain, ShardMap(2, 4, 1), 3, *F64) as st:
        with pytest.raises(ShardViolation, match="owns no sites"):
            st.meta(0)


def test_materialized_slice_gives_the_reference_digest(chain, tmp_path):
    with JStore(chain, storage_dtype=jnp.float64,
                compute_dtype=jnp.float64) as jst:
        want = jst.digest()
    sm = ShardMap(10, 3, 2)
    for host in range(3):
        dst = materialize_shard(chain, str(tmp_path / f"h{host}"), sm, host)
        files = sorted(f for f in os.listdir(dst) if f.endswith(".npz"))
        assert files == [f"site_{i:06d}.npz" for i in sm.owned_sites(host)]
        # hard links: the slice shares the source's files
        st0 = os.stat(os.path.join(dst, files[0]))
        assert st0.st_ino == os.stat(os.path.join(chain, files[0])).st_ino
        with ShardedGammaStore(dst, sm, host, *F64) as st:
            assert st.n_sites == 10
            assert st.digest() == want
        with JShardedStore(dst, JShardMap(10, 3, 2), host,
                           storage_dtype=jnp.float64,
                           compute_dtype=jnp.float64) as jst:
            assert jst.digest() == want
    # without the manifest a slice cannot answer for foreign sites
    bare = materialize_shard(chain, str(tmp_path / "bare"), sm, 0,
                             link=False)
    os.remove(os.path.join(bare, "digests.json"))
    with ShardedGammaStore(bare, sm, 0, *F64) as st:
        with pytest.raises(FileNotFoundError, match="manifest"):
            st.digest()


# ---------------------------------------------------------------------------
# codecs across the packages
# ---------------------------------------------------------------------------

def test_handoff_and_blocks_cross_between_packages():
    rng = np.random.default_rng(0)
    env, ls, lp = rng.random((8, 6)), rng.random(8), rng.random(8)
    ours = SW.encode_handoff(torch.from_numpy(env), torch.from_numpy(ls),
                             prng.key(42), 4, log_prob=torch.from_numpy(lp))
    theirs = JSW.encode_handoff(jnp.asarray(env), jnp.asarray(ls),
                                jax.random.key(42), 4, log_prob=lp)
    assert set(ours) == set(theirs)
    for k in theirs:
        a, b = np.asarray(ours[k]), np.asarray(theirs[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k
    for enc, dec, dec_lp in ((ours, JSW.decode_handoff,
                              JSW.decode_handoff_log_prob),
                             (theirs, SW.decode_handoff,
                              SW.decode_handoff_log_prob)):
        wire = RT.dict_from_bytes(JRT.dict_to_bytes(enc))
        e, s, k, site = dec(wire)
        np.testing.assert_array_equal(e, env)
        np.testing.assert_array_equal(s, ls)
        np.testing.assert_array_equal(dec_lp(wire), lp)
        assert site == 4 and k.dtype == np.uint32
    assert SW.payload_nbytes(ours) == JSW.payload_nbytes(theirs)
    blocks = {0: rng.integers(0, 3, (2, 8)), 2: rng.integers(0, 3, (3, 8))}
    wire = JRT.dict_from_bytes(RT.dict_to_bytes(SW.encode_blocks(blocks)))
    merged = JSW.decode_blocks(wire)
    np.testing.assert_array_equal(SW.assemble_blocks(merged, 5, 8),
                                  JSW.assemble_blocks(merged, 5, 8))
    with pytest.raises(RuntimeError, match="hole"):
        SW.assemble_blocks({2: blocks[2]}, 5, 8)


# ---------------------------------------------------------------------------
# sharded walks against the JAX package's
# ---------------------------------------------------------------------------

WALKS = [(h, b, k) for h in (2, 4) for b in (1, 2)
         for k in ("fixed", "dyn", "clamp")]


def _walk_fields(block, kind):
    fields = dict(segment_len=block, shard="auto")
    if kind == "dyn":
        fields["chi_profile"] = PROFILE
    if kind == "clamp":
        fields["clamp"] = CLAMP
    return fields


@pytest.mark.parametrize("hosts,block,kind", WALKS,
                         ids=[f"H{h}-b{b}-{k}" for h, b, k in WALKS])
def test_sharded_walk_matches_reference(chain, tmp_path, hosts, block, kind):
    key = 23
    fields = _walk_fields(block, kind)
    ckpt = None if kind == "clamp" else str(tmp_path / "port")
    jckpt = None if kind == "clamp" else str(tmp_path / "jax")
    outs, stats = _port_cluster(chain, hosts, prng.key(key), ckpt=ckpt,
                                **fields)
    jouts, jstats = _jax_cluster(chain, hosts, jax.random.key(key),
                                 ckpt=jckpt, **fields)
    local, lstats = _local(chain, prng.key(key),
                           **{k: v for k, v in fields.items()
                              if k != "shard"})
    sm = ShardMap(10, hosts, block)
    sched = chain_segments(10, block, None if kind != "dyn" else
                           [(0, 2, 4), (2, 8, 6), (8, 10, 4)])
    for p in range(hosts):
        np.testing.assert_array_equal(outs[p], jouts[p])
        np.testing.assert_array_equal(outs[p], local)
        st = stats[p]
        # only the owned sites were read, and no Γ crossed a wire
        assert st["io_bytes"] == lstats["io_bytes"] * len(
            sm.owned_sites(p)) // 10
        assert st["io_bytes"] == jstats[p]["io_bytes"]
        assert st["broadcast_recv_bytes"] == st["broadcast_send_bytes"] == 0
        assert st["owned_segments"] == jstats[p]["owned_segments"]
        assert st["handoffs"] == jstats[p]["handoffs"] == sum(
            p in (s, d) for _, s, d in sm.handoffs(sched))
        assert st["handoff_send_bytes"] == jstats[p]["handoff_send_bytes"]
        if kind == "clamp":
            # every process holds the local walk's log_prob; the JAX
            # package's sums in another order
            np.testing.assert_array_equal(st["log_prob"], lstats["log_prob"])
            np.testing.assert_allclose(st["log_prob"], jstats[p]["log_prob"],
                                       **TOL)
    if ckpt is not None:
        last = sm.owner(9)
        _, ours, _ = CK.load_sampler_state(os.path.join(ckpt, f"h{last}"),
                                           site=10)
        _, theirs, _ = JCK.load_sampler_state(
            os.path.join(jckpt, f"h{last}"), site=10)
        np.testing.assert_allclose(ours.env.numpy(), np.asarray(theirs.env),
                                   **TOL)
        np.testing.assert_allclose(ours.log_scale.numpy(),
                                   np.asarray(theirs.log_scale), **TOL)


def test_sharded_resume_from_the_agreed_boundary(chain, tmp_path):
    """An unclean stop leaves the hosts' checkpoints at different
    boundaries; the resume agrees on the lower one, reloads the blocks
    below it and walks the rest (handoffs again) to the same samples."""
    key = prng.key(37)
    local, _ = _local(chain, key, segment_len=2)
    ck = str(tmp_path / "ck")
    outs, _ = _port_cluster(chain, 2, key, ckpt=ck, segment_len=2,
                            shard="auto")
    np.testing.assert_array_equal(outs[0], local)
    for h, keep_to in ((0, 4), (1, 6)):
        d = os.path.join(ck, f"h{h}")
        for f in os.listdir(d):
            if int(f.split("_")[1].split(".")[0]) > keep_to:
                os.remove(os.path.join(d, f))
    outs, stats = _port_cluster(chain, 2, key, ckpt=ck, resume=True,
                                segment_len=2, shard="auto")
    for p in (0, 1):
        np.testing.assert_array_equal(outs[p], local)
    # boundary 4: segments (4,6), (8,10) walk again on host 0, (6,8) on 1
    assert (stats[0]["owned_segments"], stats[1]["owned_segments"]) == (2, 1)


def test_sharded_walk_refuses_a_kill_and_a_split_block(chain):
    def make(rt):
        return api.SamplingSession(GammaStore(chain, *F64), api.SamplerConfig(
            runtime=rt, backend="streamed", segment_len=2, shard="auto",
            kernels="torch"), device="cpu")
    errs = {}
    runtimes = api.emulated_cluster(2)

    def run(rt):
        try:
            with make(rt) as s:
                s.sample(N, prng.key(1), stop_after_segments=1)
        except ValueError as e:
            errs[rt.process_index] = str(e)
    threads = [threading.Thread(target=run, args=(rt,)) for rt in runtimes]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert set(errs) == {0, 1} and all("kill" in e for e in errs.values())
    # a χ stage that splits a block makes a segment with two owners
    prof = (4,) * 3 + (6,) * 7
    with api.SamplingSession(GammaStore(chain, *F64), api.SamplerConfig(
            backend="streamed", segment_len=2, chi_profile=prof,
            runtime=api.emulated_cluster(2)[0], shard=4, kernels="torch"),
            device="cpu") as s:
        with pytest.raises(ValueError, match="straddles"):
            s.plan(N)


def test_plan_checks_and_the_one_host_map(chain, linear_mps_10x6):
    from repro_torch.convert import mps_from_arrays
    mps = mps_from_arrays(np.asarray(linear_mps_10x6.gammas),
                          np.asarray(linear_mps_10x6.lambdas), "linear",
                          device="cpu")
    with api.SamplingSession(mps, api.SamplerConfig(
            backend="inmem", shard="auto"), device="cpu") as s:
        with pytest.raises(ValueError, match="needs backend='streamed'"):
            s.plan(8)
    with api.SamplingSession(GammaStore(chain, *F64), api.SamplerConfig(
            backend="streamed", segment_len=4, shard=2), device="cpu") as s:
        with pytest.raises(ValueError, match="whole number of segments"):
            s.plan(8)
    with api.SamplingSession(GammaStore(chain, *F64), api.SamplerConfig(
            backend="streamed", segment_len=2, shard=0), device="cpu") as s:
        with pytest.raises(ValueError, match="≥ 1 site"):
            s.plan(8)
    # one host: the degenerate map walks locally, nothing on a wire
    local, _ = _local(chain, prng.key(11), segment_len=2)
    with api.SamplingSession(GammaStore(chain, *F64), api.SamplerConfig(
            backend="streamed", segment_len=2, shard="auto",
            kernels="torch"), device="cpu") as s:
        assert s.plan(N).shard_block == 2
        np.testing.assert_array_equal(s.sample(N, prng.key(11)), local)
        info = s.explain(N)
    assert info["shard"]["hosts"] == 1 and info["shard"]["block"] == 2
    assert info["shard"]["sharded_bytes"] == 0


def test_remote_payload_carries_shard(chain):
    local, _ = _local(chain, prng.key(13), segment_len=2)
    cfg = api.SamplerConfig(backend="remote", segment_len=2, shard="auto",
                            kernels="torch")
    with api.SamplingSession(GammaStore(chain, *F64), cfg,
                             device="cpu") as s:
        plan = s.plan(N)
        assert plan.backend == "remote" and plan.shard_block is None
        np.testing.assert_array_equal(s.sample(N, prng.key(13)), local)
    payload = remote.build_payload(cfg, GammaStore(chain, *F64), N,
                                   prng.key(13))
    assert payload["config"]["shard"] == "auto"
    # the JAX package reads the port's payload config, shard untouched
    from repro.api.remote import config_from_dict as j_from_dict
    d = dict(payload["config"], kernels="xla")
    assert j_from_dict(d).shard == "auto"


W_GRID = [(1000, 100, 512, 3), (1024, 4, 10_000, 4), (64, 10, 6, 3)]


@pytest.mark.parametrize("w", W_GRID, ids=[str(w) for w in W_GRID])
def test_shard_wire_bytes_matches_reference(w):
    n, m, chi, d = w
    for hosts in (1, 2, 4, 8):
        for block in (1, 2, 10):
            ours = PM.shard_wire_bytes(PM.Workload(n_samples=n, n_sites=m,
                                                   chi=chi, d=d),
                                       hosts, block=block)
            want = JPM.shard_wire_bytes(JPM.Workload(n_samples=n, n_sites=m,
                                                     chi=chi, d=d),
                                        hosts, block=block)
            assert ours == want


# ---------------------------------------------------------------------------
# the point-to-point plane
# ---------------------------------------------------------------------------

def test_emulated_p2p_send_recv_and_allgather():
    a, b, c = api.emulated_cluster(3)
    a.send(1, {"x": np.arange(3)}, tag=7)
    a.send(1, {"x": np.arange(4)}, tag=5)
    # out of order: the tag-5 message waits in the buffer for its recv
    assert b.recv(0, tag=5)["x"].tolist() == [0, 1, 2, 3]
    assert b.recv(0, tag=7)["x"].tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="itself"):
        a.send(0, {"x": np.zeros(1)})
    outs = {}

    def run(rt):
        outs[rt.process_index] = rt.allgather_payloads(
            {"r": np.asarray([rt.process_index])})
    ts = [threading.Thread(target=run, args=(rt,)) for rt in (a, b, c)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    for p in range(3):
        assert [int(x["r"][0]) for x in outs[p]] == [0, 1, 2]
    assert a.io_counters()["p2p_send_bytes"] == 3 * 8 + 4 * 8 + 2 * 8
    assert b.io_counters()["p2p_recv_bytes"] == 3 * 8 + 4 * 8 + 2 * 8
    assert api.LocalRuntime().allgather_payloads({"x": 1}) == [{"x": 1}]
    with pytest.raises(NotImplementedError):
        api.LocalRuntime().send(1, {})


def test_wire_tags_are_disjoint():
    tags = [RT.wire_tag(t) for t in
            [None, 0, 5, ("repair", 0), ("repair", 5), ("allgather", 0),
             ("allgather", 5)]]
    assert len(set(tags[1:])) == 6 and tags[0] == 0
    with pytest.raises(ValueError):
        RT.wire_tag(("other", 1))


_GLOO_RANK = textwrap.dedent("""
    import json, os, sys
    import numpy as np, torch
    import torch.distributed as dist
    rank, world, work, root = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    dist.init_process_group("gloo", store=dist.FileStore(work + "/fs",
                            world), rank=rank, world_size=world)
    from repro_torch import api
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import GammaStore
    from repro_torch.launch.mesh import make_mesh, make_pod_mesh
    out = {}
    if world == 2:
        rt = api.get_runtime("multihost")
        other = 1 - rank
        if rank == 0:
            rt.send(1, {"x": np.arange(5.0)}, tag=3)
            rt.send(1, {"y": np.arange(2)}, tag=("repair", 3))
        else:
            out["x"] = rt.recv(0, tag=3)["x"].tolist()
            out["repair"] = rt.recv(0, tag=("repair", 3))["y"].tolist()
        g = rt.allgather_payloads({"r": np.full(rank + 1, rank)})
        out["gather"] = [p["r"].tolist() for p in g]
        cfg = api.SamplerConfig(runtime=rt, backend="streamed",
                                segment_len=2, shard="auto",
                                kernels="torch")
        with api.SamplingSession(GammaStore(root, torch.float64,
                                            torch.float64), cfg,
                                 device="cpu") as s:
            out["samples"] = s.sample(16, prng.key(23)).tolist()
            out["stats"] = {k: s.stats[k] for k in (
                "io_bytes", "handoffs", "owned_segments",
                "handoff_send_bytes", "handoff_recv_bytes")}
        rt.close()
    else:
        for name, mesh in (("pod", make_pod_mesh(2, device="cpu")),
                           ("flat", make_mesh(1, device="cpu"))):
            cfg = api.SamplerConfig(scheme="dp", kernels="torch")
            from repro_torch.convert import mps_from_arrays
            z = np.load(work + "/chain.npz")
            mps = mps_from_arrays(z["g"], z["l"], "linear", device="cpu")
            with api.SamplingSession(mps, cfg, device="cpu",
                                     mesh=mesh) as s:
                out[name] = s.sample(16, prng.key(5)).tolist()
                out[name + "_axes"] = list(s.plan(16).pconfig.data_axes)
    json.dump(out, open(f"{work}/out{rank}.json", "w"))
""")

_JAX_POD = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from jax.sharding import Mesh
    from repro import api
    from repro.core.mps import MPS
    z = np.load(sys.argv[1] + "/chain.npz")
    mps = MPS(jax.numpy.asarray(z["g"]), jax.numpy.asarray(z["l"]), "linear")
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1),
                ("pod", "data", "model"))
    with api.SamplingSession(mps, api.SamplerConfig(scheme="dp",
                                                    kernels="xla"),
                             mesh=mesh) as s:
        out = np.asarray(s.sample(16, jax.random.key(5))).tolist()
    json.dump(out, open(sys.argv[1] + "/jax.json", "w"))
""")


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    return env


def _ranks(world, work, root):
    return [subprocess.Popen([sys.executable, "-c", _GLOO_RANK, str(r),
                              str(world), str(work), str(root)], env=_env(),
                             stderr=subprocess.PIPE, text=True)
            for r in range(world)]


def _join(procs):
    for p in procs:
        try:
            _, err = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("gloo ranks hung")
        assert p.returncode == 0, err[-3000:]


def test_gloo_p2p_and_sharded_walk(chain, tmp_path):
    """2 gloo ranks: tagged send/recv (an int tag and a repair tag; gloo
    pairs a send with its receive, so a pair's messages are received in
    the order they are sent, as the walk does), the all-gather, and a
    sharded walk equal to the local one with each rank reading only its
    sites."""
    _join(_ranks(2, tmp_path, chain))
    outs = [json.load(open(tmp_path / f"out{r}.json")) for r in (0, 1)]
    assert outs[1]["x"] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert outs[1]["repair"] == [0, 1]
    for o in outs:
        assert o["gather"] == [[0], [1, 1]]
    local, lstats = _local(chain, prng.key(23), segment_len=2)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(np.asarray(o["samples"]), local)
        assert o["stats"]["io_bytes"] == lstats["io_bytes"] * (
            6 if r == 0 else 4) // 10
        assert o["stats"]["handoffs"] == 4
    assert outs[0]["stats"]["handoff_send_bytes"] + \
        outs[1]["stats"]["handoff_send_bytes"] == \
        outs[0]["stats"]["handoff_recv_bytes"] + \
        outs[1]["stats"]["handoff_recv_bytes"]


def test_pod_mesh_on_four_gloo_ranks_matches_reference(linear_mps_10x6,
                                                       tmp_path):
    """A ("pod", "data", "model") mesh of 2 × 2 × 1 gloo ranks splits the
    batch over the flattened (pod, data) line, pod-major: the JAX package's
    dp walk on the same mesh of 4 host devices, and the port's dp walk on
    a one-data-axis mesh of 4."""
    np.savez(tmp_path / "chain.npz", g=np.asarray(linear_mps_10x6.gammas),
             l=np.asarray(linear_mps_10x6.lambdas))
    ranks = _ranks(4, tmp_path, "-")
    child = subprocess.Popen([sys.executable, "-c", _JAX_POD, str(tmp_path)],
                             env=_env(), stderr=subprocess.PIPE, text=True)
    _join(ranks + [child])
    want = np.asarray(json.load(open(tmp_path / "jax.json")))
    for r in range(4):
        o = json.load(open(tmp_path / f"out{r}.json"))
        assert o["pod_axes"] == ["pod", "data"]
        np.testing.assert_array_equal(np.asarray(o["pod"]), want)
        np.testing.assert_array_equal(np.asarray(o["flat"]), want)
