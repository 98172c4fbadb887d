"""The port's streamed data plane (``repro_torch.engine``) against the JAX
package's (``repro.engine``) on the same Γ stores and seeds.

* The engine: ``StreamingEngine`` of both packages walks one store (written
  by the JAX package, fp64 identity storage, or bf16 storage decoded to
  fp64), ``inmem`` plain and micro-batched, with M not a multiple of the
  segment length, with a χ-profile, linear and Born.  Samples are equal;
  the final env and ``log_scale`` (each engine's last checkpoint, at site
  M) agree to ``rtol=1e-12, atol=1e-14``: the contractions sum in another
  order.
* Resume: ``stop_after_segments`` then ``resume=True`` gives the
  uninterrupted samples bit for bit, also from a checkpoint the JAX
  package wrote.
* The planner and the perfmodel equal the JAX package's on a grid of
  workloads and hardware.
* Streamed dp, tp_single (± measure_first) and tp_double (flat and with a
  χ-profile) on 4 gloo ranks against the port's in-memory walks.
* The CLI with ``--stream``, ``--dynamic-bond`` and both, on the CPU.
"""
import dataclasses
import itertools
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import sampler_state as JCK  # noqa: E402
from repro.core import mps as JM  # noqa: E402
from repro.core import perfmodel as JPM  # noqa: E402
from repro.data.gamma_store import GammaStore as JStore  # noqa: E402
from repro.engine import StreamPlan as JPlan  # noqa: E402
from repro.engine import StreamingEngine as JEngine  # noqa: E402
from repro.engine import explain_plan as j_explain  # noqa: E402
from repro.engine import plan_stream as j_plan  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.checkpoint import sampler_state as CK  # noqa: E402
from repro_torch.convert import mps_from_arrays  # noqa: E402
from repro_torch.core import perfmodel as PM  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import sampler as S  # noqa: E402
from repro_torch.data.gamma_store import GammaStore  # noqa: E402
from repro_torch.engine import StreamPlan, StreamingEngine  # noqa: E402
from repro_torch.engine import explain_plan, plan_stream  # noqa: E402
from repro_torch.launch import sample as cli  # noqa: E402
from repro_torch.runtime.elastic import WorkQueue  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-12, atol=1e-14)
N = 24
PROFILE = (2, 4, 6, 6, 6, 6, 4, 4, 2, 2)       # stages 1, 1, 4, 2, 2 sites

# name → (chain, storage, segment_len, micro_batch, profile)
CASES = {
    "inmem": ("linear", "fp64", 4, None, None),
    "inmem-micro": ("linear", "fp64", 4, 8, None),
    "inmem-tail": ("linear", "fp64", 3, None, None),     # 10 = 3+3+3+1
    "inmem-one-segment": ("linear", "fp64", 16, None, None),
    "inmem-bf16-store": ("linear", "bf16", 4, None, None),
    "dyn-chi": ("linear", "fp64", 3, None, PROFILE),
    "dyn-chi-micro": ("linear", "bf16", 2, 12, PROFILE),
    "born": ("born", "c128", 4, None, None),
    "born-micro-tail": ("born", "c128", 3, 6, None),
}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """Stores the JAX package wrote: {(chain, storage): root}."""
    chains = {"linear": JM.random_linear_mps(jax.random.key(0), 10, 6, 3),
              "born": JM.random_born_mps(jax.random.key(2), 7, 4, 2)}
    dtypes = {"fp64": (jnp.float64, jnp.float64),
              "bf16": (jnp.bfloat16, jnp.float64),
              "c128": (jnp.complex128, jnp.complex128)}
    out = {}
    for chain, storage in {(c[0], c[1]) for c in CASES.values()}:
        root = str(tmp_path_factory.mktemp(f"{chain}_{storage}"))
        sd, cd = dtypes[storage]
        with JStore(root, storage_dtype=sd, compute_dtype=cd) as st:
            st.write_mps(chains[chain])
        out[(chain, storage)] = root
    return out


_TORCH = {"fp64": (torch.float64, torch.float64),
          "bf16": (torch.bfloat16, torch.float64),
          "c128": (torch.complex128, torch.complex128)}
_JAX = {"fp64": (jnp.float64, jnp.float64),
        "bf16": (jnp.bfloat16, jnp.float64),
        "c128": (jnp.complex128, jnp.complex128)}


def _engine(root, storage, semantics, seg, micro, profile, ckpt=None,
            checkpoint_every=1):
    sd, cd = _TORCH[storage]
    return StreamingEngine(
        GammaStore(root, storage_dtype=sd, compute_dtype=cd),
        semantics=semantics,
        config=S.SamplerConfig(semantics=semantics, kernels="torch"),
        plan=StreamPlan(segment_len=seg, micro_batch=micro,
                        checkpoint_every=checkpoint_every),
        chi_profile=profile, checkpoint_dir=ckpt, device="cpu")


def _jax_engine(root, storage, semantics, seg, micro, profile, ckpt=None):
    from repro.core import sampler as JS
    sd, cd = _JAX[storage]
    return JEngine(
        JStore(root, storage_dtype=sd, compute_dtype=cd),
        semantics=semantics,
        config=JS.SamplerConfig(semantics=semantics, kernels="xla"),
        plan=JPlan(segment_len=seg, micro_batch=micro, checkpoint_every=1),
        chi_profile=profile, checkpoint_dir=ckpt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax(stores, tmp_path, case):
    chain, storage, seg, micro, profile = CASES[case]
    root = stores[(chain, storage)]
    key = 5
    with _jax_engine(root, storage, chain, seg, micro, profile,
                     str(tmp_path / "jax")) as je:
        want = je.sample(N, jax.random.key(key))
    with _engine(root, storage, chain, seg, micro, profile,
                 str(tmp_path / "port")) as e:
        got = e.sample(N, prng.key(key))
        stats = dict(e.stats)
    np.testing.assert_array_equal(got, want)
    n_sites = got.shape[1]
    assert stats["max_live_segments"] <= 2
    assert stats["segments"] == len([f for f in os.listdir(
        tmp_path / "port") if f.startswith("samples_")])
    # the final state: each engine's checkpoint at site M
    s_j, st_j, _ = JCK.load_sampler_state(str(tmp_path / "jax"))
    s_p, st_p, _ = CK.load_sampler_state(str(tmp_path / "port"))
    assert s_j == s_p == n_sites
    np.testing.assert_allclose(st_p.env.numpy(), np.asarray(st_j.env), **TOL)
    np.testing.assert_allclose(st_p.log_scale.numpy(),
                               np.asarray(st_j.log_scale), **TOL)


def test_engine_equals_in_memory_walk(stores):
    """§4.1 inside the port: the streamed walk of an fp64 store is the
    in-memory ``sample`` / ``sample_batched`` of the same chain."""
    root = stores[("linear", "fp64")]
    with GammaStore(root, torch.float64, torch.float64) as st:
        g, lam = st.get_segment(0, st.n_sites)
    from repro_torch.core.mps import MPS
    mps = MPS(g, lam)
    cfg = S.SamplerConfig(kernels="torch")
    key = prng.key(9)
    for seg, micro in ((4, None), (3, 6)):
        with _engine(root, "fp64", "linear", seg, micro, None) as e:
            got = e.sample(N, key)
        want = (S.sample(mps, N, key, cfg) if micro is None
                else S.sample_batched(mps, N, key, micro, cfg))
        np.testing.assert_array_equal(got, want.numpy())


def test_walk_reads_each_site_once(stores):
    store = GammaStore(stores[("linear", "bf16")], torch.bfloat16,
                       torch.float64)
    with StreamingEngine(store, config=S.SamplerConfig(kernels="torch"),
                         plan=StreamPlan(segment_len=4), device="cpu") as e:
        e.sample(8, prng.key(0))
        assert store.payload_reads == store.n_sites
        assert e.stats["io_bytes"] == store.io_bytes > 0
        assert e.stats["segments"] == 3


@pytest.mark.parametrize("fault", ["compute", "read"])
def test_a_walk_that_raises_releases_its_segments(stores, tmp_path, fault):
    """A walk that raises mid-chain (a failed step, or a corrupt site the
    prefetch reads) drains the fetch in flight and holds no segment: the
    engine's next walk counts at most two live segments and samples as a
    fresh engine does."""
    import shutil
    from repro_torch.runtime.faults import CorruptSegment
    root = str(tmp_path / "store")
    shutil.copytree(stores[("linear", "fp64")], root)
    path = os.path.join(root, "site_000006.npz")
    data = open(path, "rb").read()
    with _engine(root, "fp64", "linear", 2, None, None) as e:
        if fault == "compute":     # fails in segment [4, 6), [6, 8) fetched
            run = e._run_segment

            def failing(seg, env, log_scale, key, start):
                if start == 4:
                    raise RuntimeError("a failed step")
                return run(seg, env, log_scale, key, start)
            e._run_segment = failing
            with pytest.raises(RuntimeError, match="a failed step"):
                e.sample(N, prng.key(3))
            del e._run_segment
        else:                      # the prefetch of [6, 8) fails
            with open(path, "wb") as fh:
                fh.write(data[:len(data) // 2])
            with pytest.raises(CorruptSegment, match="site 6"):
                e.sample(N, prng.key(3))
            with open(path, "wb") as fh:
                fh.write(data)
        assert e._live == 0
        got = e.sample(N, prng.key(3))
        assert e.stats["max_live_segments"] <= 2 and e._live == 0
    with _engine(root, "fp64", "linear", 2, None, None) as fresh:
        np.testing.assert_array_equal(got, fresh.sample(N, prng.key(3)))


@pytest.mark.parametrize("seg,stop", [(3, 1), (3, 2), (4, 2)])
def test_stop_then_resume_is_bit_identical(stores, tmp_path, seg, stop):
    root = stores[("linear", "bf16")]
    key = prng.key(11)
    with _engine(root, "bf16", "linear", seg, None, PROFILE) as e:
        full = e.sample(N, key)
    ckpt = str(tmp_path)
    with _engine(root, "bf16", "linear", seg, None, PROFILE, ckpt) as e:
        part = e.sample(N, key, stop_after_segments=stop)
        assert e.stats["segments"] == stop
    assert 0 < part.shape[1] < full.shape[1]
    np.testing.assert_array_equal(part, full[:, :part.shape[1]])
    with _engine(root, "bf16", "linear", seg, None, PROFILE, ckpt) as e:
        resumed = e.sample(N, key, resume=True)
        assert e.stats["segments"] < len(e._segment_schedule())
    np.testing.assert_array_equal(resumed, full)
    # a resumed walk with another key refuses
    with _engine(root, "bf16", "linear", seg, None, PROFILE, ckpt) as e:
        with pytest.raises(ValueError, match="key"):
            e.sample(N, prng.key(12), resume=True)


def test_a_checkpoint_the_jax_package_wrote_resumes(stores, tmp_path):
    root = stores[("linear", "fp64")]
    ckpt = str(tmp_path)
    with _jax_engine(root, "fp64", "linear", 3, None, None, ckpt) as je:
        want = je.sample(N, jax.random.key(4))
    for f in os.listdir(ckpt):
        os.remove(os.path.join(ckpt, f))
    with _jax_engine(root, "fp64", "linear", 3, None, None, ckpt) as je:
        je.sample(N, jax.random.key(4), stop_after_segments=2)
    with _engine(root, "fp64", "linear", 3, None, None, ckpt) as e:
        got = e.sample(N, prng.key(4), resume=True)
        assert e.stats["segments"] == 2            # of 4: 3+3+3+1
    np.testing.assert_array_equal(got, want)


def test_a_rotted_checkpoint_refuses_to_resume(stores, tmp_path):
    root = stores[("linear", "fp64")]
    ckpt = str(tmp_path)
    with _engine(root, "fp64", "linear", 3, None, None, ckpt) as e:
        e.sample(N, prng.key(4), stop_after_segments=1)
    site = CK.newest_checkpoint_site(ckpt)
    path = os.path.join(ckpt, f"site_{site:06d}.npz")
    with np.load(path) as z:
        arrays = dict(z)
    arrays["env"] = arrays["env"] * 2
    np.savez(path, **arrays)
    from repro_torch.runtime.faults import CorruptSegment
    with _engine(root, "fp64", "linear", 3, None, None, ckpt) as e:
        with pytest.raises(CorruptSegment, match="digest"):
            e.sample(N, prng.key(4), resume=True)


def test_session_streams_a_store(stores, tmp_path):
    """The front door: a store (or its path) walks ``streamed`` by default,
    resumes per segment, and a streamed MPS source equals its in-memory
    walk; the session closes what it opened."""
    root = stores[("linear", "fp64")]
    key = prng.key(2)
    cfg = api.SamplerConfig(kernels="torch", segment_len=4)
    store = GammaStore(root, torch.float64, torch.float64)
    with api.SamplingSession(store, cfg, device="cpu") as s:
        assert s.plan(N).backend == "streamed"
        full = s.sample(N, key)
        assert s.stats["segments"] == 3
        part = s.sample(N, key, checkpoint_dir=str(tmp_path),
                        stop_after_segments=1)
        resumed = s.sample(N, key, checkpoint_dir=str(tmp_path),
                           resume=True)
        assert s.explain(N)["segment_len"] == 4
    np.testing.assert_array_equal(part, full[:, :4])
    np.testing.assert_array_equal(resumed, full)
    with api.SamplingSession(store, dataclasses.replace(
            cfg, backend="inmem"), device="cpu") as s:
        np.testing.assert_array_equal(s.sample(N, key), full)
    store.close()
    mps = mps_from_arrays(*_arrays(root), device="cpu")
    with api.SamplingSession(mps, dataclasses.replace(
            cfg, backend="streamed"), device="cpu") as s:
        np.testing.assert_array_equal(s.sample(N, key), full)
        tmp = s._tmp_store_root
        assert os.path.isdir(tmp)
    assert not os.path.exists(tmp)
    # a store path opens with the default fp32 decode: Eq. 3 then picks
    # N₂ = 8 of the 24 when 10 % of the budget holds 8·χ·d fp32 values
    with api.SamplingSession(root, dataclasses.replace(
            cfg, micro_batch="auto", device_budget=8 * 6 * 3 * 4 * 10),
            device="cpu") as s:
        assert s.plan(N).micro_batch == 8


def _arrays(root):
    with GammaStore(root, torch.float64, torch.float64) as st:
        g, lam = st.get_segment(0, st.n_sites)
    return g.numpy(), lam.numpy()


def test_session_run_queue_resumes_a_killed_batch(stores, tmp_path):
    root = stores[("linear", "fp64")]
    cfg = api.SamplerConfig(kernels="torch", segment_len=3)
    base = prng.key(3)
    with api.SamplingSession(root, cfg, device="cpu") as s:
        want = s.run_queue(WorkQueue(2), N, base)
        # batch 1 killed after one segment, then the queue picks it up
        ck = os.path.join(tmp_path, "batch_00001")
        s.sample(N, prng.fold_in(base, 1), checkpoint_dir=ck,
                 stop_after_segments=1)
        q = WorkQueue(2)
        q.complete(0)
        got = s.run_queue(q, N, base, checkpoint_root=str(tmp_path))
        assert s.stats["segments"] == 3          # of 4: one was on disk
    np.testing.assert_array_equal(got[1], want[1])
    assert not os.path.exists(ck)


# ---------------------------------------------------------------------------
# planner and perfmodel
# ---------------------------------------------------------------------------

HARDWARE = {"h100": PM.H100, "a100": PM.A100, "v5e": PM.TPU_V5E,
            "measured": dataclasses.replace(PM.H100, io_bw=2.1e9,
                                            allreduce_bw=1e11)}
WORKLOADS = [PM.Workload(10_000_000, 144, 10_000, 4, 65_536, 4096),
             PM.Workload(1_000_000, 288, 10_000, 4, 20_000, 5_000),
             PM.Workload(4096, 24, 256, 3, 1024, 1024, 16),
             PM.Workload(8176, 8176, 64, 3, 2048, 512)]


def _jax_hw(hw):
    return JPM.Hardware(**dataclasses.asdict(hw))


def _jax_w(w):
    return JPM.Workload(**dataclasses.asdict(w))


@pytest.mark.parametrize("hw", sorted(HARDWARE))
def test_perfmodel_equals_jax(hw):
    h, jh = HARDWARE[hw], _jax_hw(HARDWARE[hw])
    for w in WORKLOADS:
        jw = _jax_w(w)
        for p in (1, 2, 4, 8):
            assert PM.eq2_data_parallel(w, h, p) == \
                JPM.eq2_data_parallel(jw, jh, p)
            assert PM.eq2_data_parallel(w, h, p, overlapped=False,
                                        storage_bytes=2) == \
                JPM.eq2_data_parallel(jw, jh, p, overlapped=False,
                                      storage_bytes=2)
            for scheme in ("single", "double"):
                assert PM.eq4_tp_site(w, h, p, scheme) == \
                    JPM.eq4_tp_site(jw, jh, p, scheme)
                assert PM.eq7_tp_overhead(w, h, p, scheme) == \
                    JPM.eq7_tp_overhead(jw, jh, p, scheme)
            assert PM.choose_tp_scheme(w, h, p) == \
                JPM.choose_tp_scheme(jw, jh, p)
            assert PM.shard_wire_bytes(w, p, block=4) == \
                JPM.shard_wire_bytes(jw, p, block=4)
        assert PM.eq1_model_parallel(w, h) == JPM.eq1_model_parallel(jw, jh)
        assert PM.eq3_memory(w) == JPM.eq3_memory(jw)
        for sb in (None, 2, 8):
            assert PM.t_gamma_io(w, h, sb) == JPM.t_gamma_io(jw, jh, sb)
            assert PM.min_macro_batch_for_overlap(w, h, 0.5, sb) == \
                JPM.min_macro_batch_for_overlap(jw, jh, 0.5, sb)
        assert PM.job_admission_cost(w, h, 3) == \
            JPM.job_admission_cost(jw, jh, 3)
        for fused in (False, True):
            assert PM.site_hbm_bytes(1024, w.chi, w.d, 8, fused) == \
                JPM.site_hbm_bytes(1024, w.chi, w.d, 8, fused)


def test_h100_is_the_default():
    assert PM.Hardware() == PM.H100
    assert (PM.H100.peak_flops, PM.H100.hbm_bw, PM.H100.ici_bw,
            PM.H100.mem_capacity, PM.H100.io_bw) == (989e12, 3.35e12,
                                                     450e9, 80e9, 5e9)
    assert api.SamplerConfig().hardware == PM.H100


@pytest.mark.parametrize("hw", sorted(HARDWARE))
def test_plan_stream_and_explain_equal_jax(hw):
    h, jh = HARDWARE[hw], _jax_hw(HARDWARE[hw])
    for w, (p1, p2), budget, cb in itertools.product(
            WORKLOADS, [(1, 1), (2, 1), (1, 2), (2, 4)],
            [None, 16e9, 4e9], [4, 8]):
        jw = _jax_w(w)
        try:
            want = j_plan(jw, jh, p1=p1, p2=p2, compute_bytes=cb,
                          device_budget=budget)
        except ValueError as e:
            with pytest.raises(ValueError, match="budget"):
                plan_stream(w, h, p1=p1, p2=p2, compute_bytes=cb,
                            device_budget=budget)
            assert "budget" in str(e)
            continue
        got = plan_stream(w, h, p1=p1, p2=p2, compute_bytes=cb,
                          device_budget=budget)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert explain_plan(got, w, h, compute_bytes=cb) == \
            j_explain(want, jw, jh, compute_bytes=cb)


def test_planner_picks_two_sites_at_jiuzhang2_width():
    """The budget ``chip_smoke.py`` passes: two fp64 sites of χ = 10⁴."""
    w = PM.Workload(1024, 24, 10_000, 4, 1024, 1024)
    assert plan_stream(w, PM.H100, compute_bytes=8,
                       device_budget=16e9).segment_len == 2


# ---------------------------------------------------------------------------
# streamed dp / tp on gloo ranks
# ---------------------------------------------------------------------------

_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    work, rank = sys.argv[1], int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(work + "/store", 4),
                            rank=rank, world_size=4)
    from repro_torch import api
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import GammaStore
    from repro_torch.launch.mesh import make_mesh
    meshes = {"2x2": make_mesh(2, "cpu"), "1x4": make_mesh(4, "cpu")}
    cases = json.load(open(work + "/cases.json"))
    out = {}
    for name, c in cases.items():
        cfg = api.SamplerConfig(
            kernels="torch", scheme=c["scheme"],
            measure_first=c.get("mf", False), segment_len=c["seg"],
            micro_batch=c.get("micro"),
            chi_profile=tuple(c["profile"]) if c.get("profile") else None)
        key = prng.key(c["seed"])
        store = GammaStore(work + "/chain", torch.float64, torch.float64)
        with api.SamplingSession(store, cfg, mesh=meshes[c["mesh"]]) as s:
            out[name + "/streamed"] = s.sample(c["n"], key)
            assert s.stats["max_live_segments"] <= 2
        with api.SamplingSession(store, api.SamplerConfig(
                kernels="torch", backend="inmem", scheme=c["scheme"],
                measure_first=c.get("mf", False),
                micro_batch=c.get("micro"), chi_profile=cfg.chi_profile),
                mesh=meshes[c["mesh"]]) as s:
            out[name + "/inmem"] = s.sample(c["n"], key)
        store.close()
    np.savez(f"{work}/rank{rank}.npz", **out)
    dist.destroy_process_group()
""")

EVEN_PROFILE = [4, 4, 8, 8, 8, 8, 4, 4]
RANK_CASES = {
    "dp-2x2": dict(scheme="dp", mesh="2x2", seg=3),
    "dp-1x4": dict(scheme="dp", mesh="1x4", seg=4),
    "tp_single-2x2": dict(scheme="tp_single", mesh="2x2", seg=3),
    "tp_single_mf-1x4": dict(scheme="tp_single", mf=True, mesh="1x4",
                             seg=2),
    "tp_double-1x4": dict(scheme="tp_double", mesh="1x4", seg=3),
    "tp_single-micro-2x2": dict(scheme="tp_single", mesh="2x2", seg=4,
                                micro=8),
    "dp-dyn-chi-2x2": dict(scheme="dp", mesh="2x2", seg=3,
                           profile=EVEN_PROFILE),
    "dp-dyn-chi-1x4": dict(scheme="dp", mesh="1x4", seg=2,
                           profile=EVEN_PROFILE),
    "tp_double-dyn-chi-2x2": dict(scheme="tp_double", mesh="2x2", seg=2,
                                  profile=EVEN_PROFILE),
    "tp_single_mf-dyn-chi-1x4": dict(scheme="tp_single", mf=True,
                                     mesh="1x4", seg=3,
                                     profile=EVEN_PROFILE),
}


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    work = tmp_path_factory.mktemp("stream_ranks")
    chain = JM.random_linear_mps(jax.random.key(3), 8, 8, 3)
    with GammaStore(str(work / "chain"), torch.float64,
                    torch.float64) as st:
        st.write_mps(mps_from_arrays(np.asarray(chain.gammas),
                                     np.asarray(chain.lambdas),
                                     device="cpu"))
    cases = {k: dict(v, n=32, seed=6) for k, v in RANK_CASES.items()}
    (work / "cases.json").write_text(__import__("json").dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(work),
                               str(r)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    for r, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
            pytest.fail(f"rank {r} did not finish in 150 s:\n{log[-3000:]}")
        assert p.returncode == 0, f"rank {r} failed:\n{log[-5000:]}"
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(4)]


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_streamed_parallel_walks_equal_in_memory(rank_results, case):
    for r, res in enumerate(rank_results):
        np.testing.assert_array_equal(res[case + "/streamed"],
                                      res[case + "/inmem"], err_msg=str(r))
        np.testing.assert_array_equal(res[case + "/streamed"],
                                      rank_results[0][case + "/streamed"])
    # every scheme draws the same samples per seed on one mesh (§4.1)
    mesh = RANK_CASES[case]["mesh"]
    dp = "dp-dyn-chi-" if "dyn-chi" in case else "dp-"
    if "micro" not in case:
        np.testing.assert_array_equal(rank_results[0][case + "/streamed"],
                                      rank_results[0][dp + mesh + "/streamed"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--stream"], ["--dynamic-bond"],
                                   ["--stream", "--dynamic-bond"]],
                         ids=["stream", "dynamic-bond", "both"])
def test_stream_and_dynamic_bond_cli_flags_run(flags, tmp_path, capsys):
    argv = ["--sites", "7", "--chi", "8", "--d", "3", "--samples", "32",
            "--macro-batches", "2", "--out", str(tmp_path), "--device",
            "cpu", "--segment-len", "2", *flags]
    cli.main(argv)
    out = capsys.readouterr().out
    batches = [np.load(tmp_path / f"batch_{b:05d}.npy") for b in (0, 1)]
    assert all(b.shape == (16, 7) for b in batches)
    assert ("table1:" in out) == ("--dynamic-bond" in flags)
    if "--stream" in flags:
        assert "streaming stats:" in out
        assert (tmp_path / "gamma_store" / "digests.json").exists()
        (tmp_path / "batch_00001.npy").unlink()
        cli.main(argv)                   # regenerates batch 1 alone
        np.testing.assert_array_equal(
            np.load(tmp_path / "batch_00001.npy"), batches[1])


def test_gbs_like_site_is_site_i_of_the_chain():
    """A chain too large for the device is drawn a site at a time: site i
    alone equals site i of ``gbs_like_mps``, which equals the JAX
    package's chain."""
    from repro_torch.core import mps as M

    mps = M.gbs_like_mps(prng.key(5), 7, 6, 3, device="cpu")
    jm = JM.gbs_like_mps(jax.random.key(5), 7, 6, 3)
    np.testing.assert_allclose(mps.gammas.numpy(), np.asarray(jm.gammas),
                               rtol=1e-13)
    for i in range(7):
        g, lam = M.gbs_like_site(prng.key(5), i, 7, 6, 3, device="cpu")
        assert torch.equal(g, mps.gammas[i]) and torch.equal(
            lam, mps.lambdas[i])


def test_unported_engine_options_name_their_rows(stores):
    """The engine's last unported option, ``shard`` (ROADMAP.md §1 row
    10b), is ported: a map of the wrong chain or host count is refused as
    the JAX package refuses it, and the one-host map walks the unsharded
    samples (the sharded walks: tests/test_torch_shard.py)."""
    from repro_torch.shard import ShardMap
    root = stores[("linear", "fp64")]
    with GammaStore(root, torch.float64, torch.float64) as store:
        with pytest.raises(ValueError, match="covers 4 sites"):
            StreamingEngine(store, device="cpu", shard=ShardMap(4, 1, 2))
        with pytest.raises(ValueError, match="spans 2 hosts"):
            StreamingEngine(store, device="cpu", shard=ShardMap(10, 2, 2))
        kw = dict(config=S.SamplerConfig(kernels="torch"),
                  plan=StreamPlan(segment_len=2), device="cpu")
        plain = StreamingEngine(store, **kw)
        want = plain.sample(N, prng.key(3))
        plain.close(close_store=False)
        one = StreamingEngine(store, shard=ShardMap(10, 1, 2), **kw)
        np.testing.assert_array_equal(one.sample(N, prng.key(3)), want)
        assert one.stats["handoffs"] == 0
        one.close(close_store=False)


@pytest.mark.parametrize("clamp", [{0: 1}, {3: 2, 8: 0}],
                         ids=["clamp={0: 1}", "clamp={3: 2, 8: 0}"])
def test_ported_engine_options_walk(stores, clamp):
    """ROADMAP.md §1 row 12: ``clamp`` walks, segment by segment, the
    in-memory clamped walk of the same chain, ``log_prob`` with it."""
    from repro_torch.core import clamped as CL
    from repro_torch.workloads import clamp as WC

    root = stores[("linear", "fp64")]
    with GammaStore(root, torch.float64, torch.float64) as store:
        g, lam = store.get_segment(0, store.n_sites)
        with StreamingEngine(store, config=S.SamplerConfig(kernels="torch"),
                             plan=StreamPlan(segment_len=3), clamp=clamp,
                             device="cpu") as e:
            got = e.sample(N, prng.key(2))
            lp = e.stats["log_prob"]
    from repro_torch.core.mps import MPS
    mask, vals = WC.segment_clamp_arrays(
        WC.clamp_map(WC.normalize_clamp(clamp)), 0, g.shape[0], N)
    want, want_lp = CL.sample_clamped(MPS(g, lam), N, prng.key(2),
                                      S.SamplerConfig(kernels="torch"),
                                      mask, vals)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(lp, want_lp.numpy())
