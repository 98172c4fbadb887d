"""Dynamic bond dimensions (§3.4.2): the port's ``core/dynamic_bond.py``
against the JAX package's on the same profiles, chains and seeds.

* The profile, the buckets, the stages and Table 1 equal the JAX package's
  for a grid of (M, χ, n_photon, buckets).
* ``sample_staged`` and ``sample_staged_batched`` on a converted chain:
  samples equal to the JAX package's, the final env and ``log_scale``
  within ``rtol=1e-12, atol=1e-14`` (sums in another order).  The JAX
  package's functions return the samples alone, so its final state comes
  from the same stage loop over its own pieces (``truncate_mps_to_profile``,
  ``fit_env``, ``sample_chain``).
* The session's staged cells: seq in-process against the JAX package's
  seq; dp, tp_single (± measure_first) and tp_double on 4 gloo ranks
  against the JAX package's dyn-χ dp cell on a mesh with the same number
  of data shards (one device in-process for p₁ = 1, two forced host
  devices in a subprocess for p₁ = 2).  The JAX package's own dyn-χ × TP
  cells fail on its model-sharded environment, and every scheme draws the
  same samples per seed, so its dp cell is the reference of the TP cells.
"""
import itertools
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as jax_api  # noqa: E402
from repro.core import dynamic_bond as JDB  # noqa: E402
from repro.core import mps as JM  # noqa: E402
from repro.core import sampler as JS  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import mps_from_arrays  # noqa: E402
from repro_torch.core import dynamic_bond as DB  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import sampler as S  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-12, atol=1e-14)
N = 32
EVEN_PROFILE = (4, 4, 8, 8, 8, 8, 4, 4)       # even stage boundaries


@pytest.mark.parametrize("n_sites,chi,n_photon", itertools.product(
    [1, 2, 7, 24, 144], [1, 16, 256, 10_000], [0.3, 1.0, 1.62, 8.82]))
def test_profile_buckets_stages_and_table1_equal_jax(n_sites, chi, n_photon):
    for d in (3, 4):
        prof = DB.area_law_profile(n_sites, chi, n_photon=n_photon, d=d)
        want = JDB.area_law_profile(n_sites, chi, n_photon=n_photon, d=d)
        np.testing.assert_array_equal(prof, want)
        assert prof.dtype == want.dtype
    for buckets in ([chi], sorted({max(1, chi // 4), max(1, chi // 2), chi}),
                    [max(1, chi // 8), max(1, chi // 3)]):
        b = DB.bucketize(prof, buckets)
        np.testing.assert_array_equal(b, JDB.bucketize(want, buckets))
        assert [(s.start, s.stop, s.chi) for s in
                DB.stages_from_profile(b)] == \
            [(s.start, s.stop, s.chi) for s in JDB.stages_from_profile(b)]
    for fixed in (chi, max(1, chi // 2)):
        assert DB.table1_metrics(prof, fixed) == \
            JDB.table1_metrics(want, fixed)


def test_jiuzhang2_profile_at_depth_24():
    """The χ-stages and Table 1 of ``chip_smoke.py``'s dyn-χ walk."""
    prof = DB.area_law_profile(24, 10_000, n_photon=1.62, d=4)
    b = DB.bucketize(prof, (256, 1024, 4096, 10_000))
    assert [(s.start, s.stop, s.chi) for s in DB.stages_from_profile(b)] == [
        (0, 5, 256), (5, 7, 1024), (7, 8, 4096), (8, 15, 10_000),
        (15, 16, 4096), (16, 18, 1024), (18, 24, 256)]
    m = DB.table1_metrics(prof, 10_000)
    assert (round(m["equiv_chi"], 1), round(m["step_ratio"], 3),
            round(m["comp_ratio"], 3)) == (4912.6, 0.208, 0.241)


def test_fit_env_slices_and_pads():
    env = torch.arange(12.0, dtype=torch.float64).reshape(3, 4)
    assert torch.equal(DB.fit_env(env, 2), env[:, :2])
    assert DB.fit_env(env, 2).is_contiguous()
    grown = DB.fit_env(env, 6)
    assert torch.equal(grown[:, :4], env) and not grown[:, 4:].any()
    assert DB.fit_env(env, 4) is env


def _jax_staged_state(mps, bucketed, n, key, cfg):
    """The JAX package's staged walk, keeping its final state."""
    stage_mps = JDB.truncate_mps_to_profile(mps, bucketed)
    state = JS.init_state(stage_mps[0], n, key, cfg)
    outs, offset = [], 0
    for sm in stage_mps:
        state = JS.SamplerState(JDB.fit_env(state.env, sm.chi), state.key,
                                state.log_scale)
        res = JS.sample_chain(sm, state, cfg, start_site=offset)
        state, offset = res.state, offset + sm.n_sites
        outs.append(res.samples)
    return np.asarray(np.concatenate(outs, axis=0).T), state


CHAINS = {"linear": lambda: JM.gbs_like_mps(jax.random.key(2), 12, 16, 3),
          "born": lambda: JM.random_born_mps(jax.random.key(4), 9, 8, 2)}


@pytest.mark.parametrize("chain", sorted(CHAINS))
@pytest.mark.parametrize("seed", [0, 3])
def test_sample_staged_matches_jax(chain, seed):
    jm = CHAINS[chain]()
    prof = DB.area_law_profile(jm.n_sites, jm.chi, n_photon=1.0)
    buck = DB.bucketize(prof, [max(1, jm.chi // 4), jm.chi // 2, jm.chi])
    assert len(DB.stages_from_profile(buck)) > 2
    mps = mps_from_arrays(np.asarray(jm.gammas), np.asarray(jm.lambdas),
                          jm.semantics, device="cpu")
    jcfg = JS.SamplerConfig(semantics=jm.semantics, kernels="xla")
    cfg = S.SamplerConfig(semantics=jm.semantics, kernels="torch")
    want, jstate = _jax_staged_state(jm, buck, N, jax.random.key(seed), jcfg)
    np.testing.assert_array_equal(
        want, np.asarray(JDB.sample_staged(jm, buck, N, jax.random.key(seed),
                                           jcfg)))
    got, state = DB.walk_stages(DB.truncate_mps_to_profile(mps, buck), N,
                                prng.key(seed), cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        DB.sample_staged(mps, buck, N, prng.key(seed), cfg).numpy(), want)
    np.testing.assert_allclose(state.env.numpy(), np.asarray(jstate.env),
                               **TOL)
    np.testing.assert_allclose(state.log_scale.numpy(),
                               np.asarray(jstate.log_scale), **TOL)
    for micro in (8, 16):
        np.testing.assert_array_equal(
            DB.sample_staged_batched(mps, buck, N, prng.key(seed), micro,
                                     cfg).numpy(),
            np.asarray(JDB.sample_staged_batched(
                jm, buck, N, jax.random.key(seed), micro, jcfg)))


@pytest.mark.parametrize("micro", [None, 8])
def test_session_staged_seq_matches_jax(micro):
    jm = CHAINS["linear"]()
    prof = tuple(int(c) for c in DB.bucketize(
        DB.area_law_profile(12, 16), [4, 8, 16]))
    with jax_api.SamplingSession(jm, jax_api.SamplerConfig(
            scheme="seq", kernels="xla", chi_profile=prof,
            micro_batch=micro)) as js:
        want = js.sample(N, jax.random.key(1))
    mps = mps_from_arrays(np.asarray(jm.gammas), np.asarray(jm.lambdas),
                          device="cpu")
    with api.SamplingSession(mps, api.SamplerConfig(
            kernels="torch", chi_profile=prof, micro_batch=micro),
            device="cpu") as s:
        plan = s.plan(N)
        got = s.sample(N, prng.key(1))
    assert plan.stages == tuple((st.start, st.stop, st.chi) for st in
                                DB.stages_from_profile(np.asarray(prof)))
    np.testing.assert_array_equal(got, want)


def _mesh(p1, p2):
    return SimpleNamespace(shape={"data": p1, "model": p2},
                           axis_names=("data", "model"),
                           device=torch.device("cpu"))


@pytest.mark.parametrize("scheme,profile,match", [
    ("tp_single", (4, 6, 8, 8), "does not divide"),
    ("tp_double", (4, 8, 8, 8), "even"),
    ("baseline19", (4, 8, 8, 8), "baseline"),
])
def test_staged_plans_refuse_what_they_cannot_walk(scheme, profile, match):
    mps = mps_from_arrays(*[np.asarray(a) for a in (
        JM.random_linear_mps(jax.random.key(0), 4, 8, 2).gammas,
        JM.random_linear_mps(jax.random.key(0), 4, 8, 2).lambdas)],
        device="cpu")
    with api.SamplingSession(mps, api.SamplerConfig(
            scheme=scheme, chi_profile=profile), device="cpu",
            mesh=_mesh(4 if scheme == "baseline19" else 1,
                       1 if scheme == "baseline19" else 4)) as s:
        with pytest.raises(ValueError, match=match):
            s.plan(8)


# ---------------------------------------------------------------------------
# the staged dp / tp cells on gloo ranks
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
    from repro_torch.convert import mps_from_arrays
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_mesh
    meshes = {"2x2": make_mesh(2, "cpu"), "1x4": make_mesh(4, "cpu")}
    z = np.load(work + "/chain.npz")
    mps = mps_from_arrays(z["g"], z["l"], device="cpu")
    out = {}
    for name, c in json.load(open(work + "/cases.json")).items():
        cfg = api.SamplerConfig(kernels="torch", scheme=c["scheme"],
                                measure_first=c.get("mf", False),
                                micro_batch=c.get("micro"),
                                chi_profile=tuple(c["profile"]))
        with api.SamplingSession(mps, cfg, mesh=meshes[c["mesh"]]) as s:
            out[name] = s.sample(c["n"], prng.key(c["seed"]))
    np.savez(f"{work}/rank{rank}.npz", **out)
    dist.destroy_process_group()
""")

_JAX_DP2 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from jax.sharding import Mesh
    from repro import api
    from repro.core.mps import MPS
    work = sys.argv[1]
    z = np.load(work + "/chain.npz")
    prof = tuple(int(c) for c in np.load(work + "/profile.npy"))
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    out = {}
    for micro in (None, 8):
        with api.SamplingSession(MPS(z["g"], z["l"], "linear"),
                                 api.SamplerConfig(scheme="dp", kernels="xla",
                                                   chi_profile=prof,
                                                   micro_batch=micro),
                                 mesh=mesh) as s:
            out[f"micro{micro}"] = s.sample(int(sys.argv[2]),
                                            jax.random.key(int(sys.argv[3])))
    np.savez(work + "/jax_dp2.npz", **out)
""")

RANK_CASES = {f"{scheme}{'_mf' if mf else ''}-{mesh}": dict(
    scheme=scheme, mf=mf, mesh=mesh)
    for mesh in ("2x2", "1x4")
    for scheme, mf in (("dp", False), ("tp_single", False),
                       ("tp_single", True), ("tp_double", False))}
RANK_CASES["tp_single-micro8-2x2"] = dict(scheme="tp_single", mesh="2x2",
                                          micro=8)
SEED = 5


@pytest.fixture(scope="module")
def staged_cells(tmp_path_factory):
    """(port rank results, JAX dp at p₁ = 2, JAX dp at p₁ = 1)."""
    work = tmp_path_factory.mktemp("staged_ranks")
    jm = JM.random_linear_mps(jax.random.key(3), 8, 8, 3)
    np.savez(work / "chain.npz", g=np.asarray(jm.gammas),
             l=np.asarray(jm.lambdas))
    np.save(work / "profile.npy", np.asarray(EVEN_PROFILE))
    cases = {k: dict(v, n=N, seed=SEED, profile=EVEN_PROFILE)
             for k, v in RANK_CASES.items()}
    (work / "cases.json").write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = [(f"rank {r}", subprocess.Popen(
        [sys.executable, "-c", _RANK, str(work), str(r)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for r in range(4)]
    procs.append(("the JAX dp cell", subprocess.Popen(
        [sys.executable, "-c", _JAX_DP2, str(work), str(N), str(SEED)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)))
    # p₁ = 1: the JAX package's dp cell on its one CPU device, meanwhile
    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    with jax_api.SamplingSession(jm, jax_api.SamplerConfig(
            scheme="dp", kernels="xla", chi_profile=EVEN_PROFILE),
            mesh=mesh1) as js:
        dp1 = js.sample(N, jax.random.key(SEED))
    for what, p in procs:
        try:
            log, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            p.kill()
            log, _ = p.communicate()
            pytest.fail(f"{what} did not finish in 150 s:\n{log[-3000:]}")
        assert p.returncode == 0, f"{what} failed:\n{log[-5000:]}"
    return ([dict(np.load(work / f"rank{r}.npz")) for r in range(4)],
            dict(np.load(work / "jax_dp2.npz")), dp1)


@pytest.mark.parametrize("case", sorted(RANK_CASES))
def test_staged_parallel_cells_match_jax_dp(staged_cells, case):
    ranks, dp2, dp1 = staged_cells
    c = RANK_CASES[case]
    if c["mesh"] == "2x2":
        want = dp2["micro8" if c.get("micro") else "microNone"]
    else:
        want = dp1
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[case], want, err_msg=f"rank {r}")
