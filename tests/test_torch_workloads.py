"""Conditional sampling and the workloads layer: the port's
``repro_torch.workloads`` and ``core/clamped.py`` against the JAX
package's ``repro.workloads`` and ``repro.core.clamped`` on the same
inputs (numpy, from a seed) and keys.

* The clamp spec: ``normalize_clamp``, ``validate_clamp``, ``clamp_map``,
  ``segment_clamp_arrays`` and ``parse_clamp_arg`` give the reference's
  results on good inputs and raise its ``ValueError`` messages on bad ones.
* Clamped walks (``clamped_segment``, whole and micro-batched; scalar,
  per-sample, full and zero-weight clamps; linear fp64/fp32, Born
  complex128, the ``mxu_bf16``/``store_bf16`` tiers): samples equal to the
  reference's; env, ``log_scale`` and ``log_prob`` within ``rtol = atol =
  1e-12`` in fp64 and ``1e-5`` in fp32 (the sums run in another order; a
  clamp of zero weight gives NaN where the reference does).  A fully
  clamped walk's ``log_prob`` is the log of the joint of
  ``enumerate_probabilities``.
* The session (inmem and streamed; seq and a one-rank dp) against the
  reference's session; dp and tp_* → dp on 4 gloo ranks against the
  reference's clamped dp cell (one device in-process for p₁ = 1, two forced
  host devices in one JAX child for p₁ = 2); the streamed engine against
  the reference's on one store.
* Ingest: the same tensors give the same chain and the same store digest.
* Scenarios: the same scores as the reference's for the same seed; the
  CLI passes all three on the CPU.
* Refusals: checkpoint/resume, baseline19, Born with ``compute_dtype``.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as jax_api  # noqa: E402
from repro.core import clamped as JCL  # noqa: E402
from repro.core import mps as JM  # noqa: E402
from repro.core import precision as JP  # noqa: E402
from repro.core import sampler as JS  # noqa: E402
from repro.data.gamma_store import GammaStore as JStore  # noqa: E402
from repro.engine import StreamPlan as JPlan  # noqa: E402
from repro.engine import StreamingEngine as JEngine  # noqa: E402
from repro.workloads import clamp as JWC  # noqa: E402
from repro.workloads import ingest as JIG  # noqa: E402
from repro.workloads import scenarios as JSC  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.convert import mps_from_arrays  # noqa: E402
from repro_torch.core import clamped as CL  # noqa: E402
from repro_torch.core import mps as M  # noqa: E402
from repro_torch.core import precision as P  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import sampler as S  # noqa: E402
from repro_torch.data.gamma_store import GammaStore  # noqa: E402
from repro_torch.engine import StreamPlan, StreamingEngine  # noqa: E402
from repro_torch.launch import scenarios as scenarios_cli  # noqa: E402
from repro_torch.workloads import clamp as WC  # noqa: E402
from repro_torch.workloads import ingest as IG  # noqa: E402
from repro_torch.workloads import scenarios as SC  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = {torch.float64: dict(rtol=1e-12, atol=1e-12),
       torch.float32: dict(rtol=1e-5, atol=1e-5)}
N = 32


# ---------------------------------------------------------------------------
# the clamp spec
# ---------------------------------------------------------------------------

GOOD_SPECS = [None, {}, [], {2: 1}, {"3": 0, 1: 2}, {1.0: 1},
              {4: [0, 1, 0]}, {0: np.array([1, 2])}, {5: np.int64(2)},
              [(3, 1), (0, 0)], ((2, (1, 0)), (0, 1)), {2: np.array(1)}]
BAD_SPECS = [{"abc": 0}, {1.5: 0}, {-1: 0}, {0: -1}, {0: "1"}, {0: []},
             {0: [1, -2]}, {0: {1: 2}}, [[2, 1], [2, 0]], [(1, 2, 3)],
             ["ab"], 7, "0=1", {0: [1, "x"]}, {0: None}]


@pytest.mark.parametrize("spec", GOOD_SPECS, ids=repr)
def test_normalize_clamp_equals_jax(spec):
    got = WC.normalize_clamp(spec)
    assert got == JWC.normalize_clamp(spec)
    assert WC.normalize_clamp(got) == got          # idempotent
    assert hash(got) == hash(JWC.normalize_clamp(spec))
    assert api.SamplerConfig(clamp=spec).clamp == \
        jax_api.SamplerConfig(clamp=spec).clamp == got
    cmap, jmap = WC.clamp_map(got), JWC.clamp_map(got)
    assert (cmap is None) == (jmap is None)
    if cmap is not None:
        assert cmap.keys() == jmap.keys()
        for k in cmap:
            np.testing.assert_array_equal(cmap[k], jmap[k])
        n = max([len(v) for v in cmap.values() if np.ndim(v)] or [3])
        for start, length in ((0, 6), (2, 3), (5, 1)):
            for a, b in zip(WC.segment_clamp_arrays(cmap, start, length, n),
                            JWC.segment_clamp_arrays(jmap, start, length, n)):
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


def _raised(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("spec", BAD_SPECS, ids=repr)
def test_malformed_clamp_raises_as_jax(spec):
    msg = _raised(WC.normalize_clamp, spec)
    assert msg is not None and msg == _raised(JWC.normalize_clamp, spec)
    with pytest.raises(ValueError):
        api.SamplerConfig(clamp=spec)


@pytest.mark.parametrize("spec,kw", [
    ({2: 1}, dict(n_sites=6, d=3)), ({6: 0}, dict(n_sites=6, d=3)),
    ({0: 3}, dict(n_sites=6, d=3)), ({1: [0, 2, 1]}, dict(n_sites=6, d=3)),
    ({1: [0, 2, 1]}, dict(n_sites=6, d=3, n_samples=3)),
    ({1: [0, 2, 1]}, dict(n_sites=6, d=3, n_samples=4)),
    ({1: [0, 3, 1]}, dict(n_sites=6, d=3, n_samples=3)),
    (None, dict(n_sites=1, d=1)),
])
def test_validate_clamp_equals_jax(spec, kw):
    spec = WC.normalize_clamp(spec)
    assert _raised(WC.validate_clamp, spec, **kw) == \
        _raised(JWC.validate_clamp, spec, **kw)


@pytest.mark.parametrize("text", ["", "1=0", "1=0,3=1", " 2 = 1 , ,5=0",
                                  "1=0,1=2", "x=1", "1", "1=a", "1=0,=2"])
def test_parse_clamp_arg_equals_jax(text):
    try:
        want = JWC.parse_clamp_arg(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            WC.parse_clamp_arg(text)
        assert str(got.value) == str(e)
        return
    assert WC.parse_clamp_arg(text) == want


# ---------------------------------------------------------------------------
# clamped walks against repro.core.clamped
# ---------------------------------------------------------------------------

def _chain(kind, seed=0):
    """(JAX chain, port chain, port compute_dtype) of one kind."""
    if kind == "born":
        jm = JM.random_born_mps(jax.random.key(seed + 2), 6, 4, 3)
    else:
        jm = JM.random_linear_mps(jax.random.key(seed), 6, 4, 3)
    compute = None
    if kind == "fp32":
        jm = jm.astype(jnp.float32)
    elif kind == "mxu_bf16":
        jm, compute = jm.astype(jnp.float32), torch.bfloat16
    elif kind == "store_bf16":
        jm = JM.MPS(jm.gammas.astype(jnp.bfloat16),
                    jm.lambdas.astype(jnp.float32), "linear")
        compute = torch.bfloat16
    elif kind == "zero_weight":
        # outcome 2 at site 1 has no weight: a clamp there collapses to 0
        jm = JM.MPS(jm.gammas.at[1, :, :, 2].set(0.0), jm.lambdas, "linear")
    pm = mps_from_arrays(np.asarray(jm.gammas), np.asarray(jm.lambdas),
                         jm.semantics, device="cpu")
    return jm, pm, compute


CLAMPS = {"scalar": {1: 0, 4: 2}, "per_sample": {2: list(range(N))},
          "first_and_last": {0: 1, 5: 0}, "full": dict(enumerate(
              (1, 0, 2, 1, 0, 1))), "zero_weight": {1: 2, 3: 1}}
WALKS = [("fp64", "scalar", None), ("fp64", "scalar", 8),
         ("fp64", "scalar", N), ("fp64", "per_sample", None),
         ("fp64", "per_sample", 8), ("fp64", "first_and_last", None),
         ("fp64", "full", None), ("zero_weight", "zero_weight", None),
         ("zero_weight", "zero_weight", 16), ("fp32", "scalar", None),
         ("fp32", "per_sample", 16), ("born", "scalar", None),
         ("born", "per_sample", 8), ("mxu_bf16", "scalar", None),
         ("store_bf16", "scalar", 16), ("store_bf16", "per_sample", None)]


def _arrays(clamp, n_sites, n, start=0):
    spec = WC.normalize_clamp({k: (np.asarray(v) % 3 if np.ndim(v) else v)
                               for k, v in clamp.items()})
    return spec, WC.segment_clamp_arrays(WC.clamp_map(spec), start, n_sites,
                                         n)


@pytest.mark.parametrize("kind,clamp,micro", WALKS,
                         ids=["-".join(map(str, w)) for w in WALKS])
def test_clamped_segment_matches_jax(kind, clamp, micro):
    jm, pm, compute = _chain(kind)
    _, (mask, vals) = _arrays(CLAMPS[clamp], jm.n_sites, N)
    jcfg = JS.SamplerConfig(semantics=jm.semantics, kernels="xla",
                            compute_dtype=compute and jnp.bfloat16)
    cfg = S.SamplerConfig(semantics=pm.semantics, kernels="torch",
                          compute_dtype=compute)
    js = JS.init_state(jm, N, jax.random.key(3), jcfg)
    want = JCL.clamped_segment(jm.gammas, jm.lambdas, js.env, js.key, 0,
                               mask, vals, jcfg, log_scale=js.log_scale,
                               micro_batch=micro)
    st = S.init_state(pm, N, prng.key(3), cfg)
    got = CL.clamped_segment(pm.gammas, pm.lambdas, st.env, st.key, 0, mask,
                             vals, cfg, log_scale=st.log_scale,
                             micro_batch=micro)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.all(got[0].numpy()[mask] == vals[mask])   # the clamp holds
    assert got[3].dtype == P.real_dtype_of(st.env.dtype)
    tol = TOL[P.real_dtype_of(st.env.dtype)]
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
    lp = got[3].numpy()
    if clamp == "zero_weight":
        # log(tiny) at the impossible site, then 0/0 at the next clamp
        assert np.isnan(lp).all() and np.isnan(np.asarray(want[3])).all()
    else:
        assert np.all(np.isfinite(lp)) and np.all(lp < 0)


def test_zero_weight_clamp_gives_log_tiny():
    jm, pm, _ = _chain("zero_weight")
    _, (mask, vals) = _arrays({1: 2}, jm.n_sites, N)
    cfg = S.SamplerConfig(kernels="torch")
    samples, lp = CL.sample_clamped(pm, N, prng.key(1), cfg, mask, vals)
    jsmp, jlp = JCL.sample_clamped(jm, N, jax.random.key(1),
                                   JS.SamplerConfig(), mask, vals)
    np.testing.assert_array_equal(samples.numpy(), np.asarray(jsmp))
    for got in (lp.numpy(), np.asarray(jlp)):
        np.testing.assert_allclose(got, np.log(np.finfo(np.float64).tiny),
                                   rtol=1e-12)


def test_fully_clamped_log_prob_is_log_joint():
    jm, pm, _ = _chain("fp64")
    outcome = CLAMPS["full"]
    _, (mask, vals) = _arrays(outcome, pm.n_sites, 8)
    _, lp = CL.sample_clamped(pm, 8, prng.key(0), S.SamplerConfig(
        kernels="torch"), mask, vals)
    idx = np.ravel_multi_index(tuple(outcome.values()), (3,) * pm.n_sites)
    for joint in (M.enumerate_probabilities(pm),
                  JM.enumerate_probabilities(jm)):
        np.testing.assert_allclose(lp.numpy(), np.log(joint[idx]),
                                   rtol=1e-10)


def test_unmasked_clamped_walk_is_the_sampler():
    _, pm, _ = _chain("fp64")
    mask = np.zeros(pm.n_sites, dtype=bool)
    vals = np.zeros((pm.n_sites, N), dtype=np.int32)
    cfg = S.SamplerConfig(kernels="torch")
    out, lp = CL.sample_clamped(pm, N, prng.key(9), cfg, mask, vals)
    np.testing.assert_array_equal(out.numpy(),
                                  S.sample(pm, N, prng.key(9), cfg).numpy())
    assert not lp.any()


def test_sample_range_stats_equals_jax():
    rng = np.random.default_rng(4)
    env = rng.uniform(size=(16, 7)) * 10.0 ** rng.integers(-30, 5, (16, 1))
    env[3, 2:] = 0.0
    env[5] = 0.0
    got = P.sample_range_stats(torch.from_numpy(env))
    want = JP.sample_range_stats(jnp.asarray(env))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the session, in memory and streamed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A 10-site linear chain and an fp64 store of it the JAX package
    wrote: (JAX MPS, port MPS, store root)."""
    jm = JM.random_linear_mps(jax.random.key(6), 10, 6, 3)
    root = str(tmp_path_factory.mktemp("clamp_store"))
    with JStore(root, storage_dtype=jnp.float64,
                compute_dtype=jnp.float64) as st:
        st.write_mps(jm)
        st.write_digest_manifest()
    return jm, mps_from_arrays(np.asarray(jm.gammas), np.asarray(jm.lambdas),
                               device="cpu"), root


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group and its 1×1 mesh, as the CLI makes them."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh
    created = init_distributed(torch.device("cpu"))
    yield make_mesh(1, "cpu")
    if created:
        dist.destroy_process_group()


SESSION_CASES = {"seq": ("seq", None, {2: 1, 7: 0}),
                 "seq-micro": ("seq", 8, {2: 1, 7: 0}),
                 "seq-per-sample": ("seq", None, {5: [i % 3 for i in range(
                     N)]}),
                 "dp": ("dp", None, {2: 1, 7: 0}),
                 "dp-micro-per-sample": ("dp", 8, {0: [i % 2 for i in range(
                     N)], 9: 2})}


@pytest.mark.parametrize("case", sorted(SESSION_CASES))
def test_session_clamped_matches_jax(chain, one_rank, case):
    """In memory and streamed (segments of 3 sites), against the JAX
    package's in-memory session; the streamed ``log_prob`` equals the
    in-memory one."""
    jm, pm, root = chain
    scheme, micro, clamp = SESSION_CASES[case]
    jmesh = (jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                               ("data", "model")) if scheme == "dp" else None)
    with jax_api.SamplingSession(jm, jax_api.SamplerConfig(
            scheme=scheme, kernels="xla", clamp=clamp, micro_batch=micro),
            mesh=jmesh) as js:
        want = js.sample(N, jax.random.key(3))
        want_lp = np.asarray(js.stats["log_prob"])
    mesh = one_rank if scheme == "dp" else None
    cfg = api.SamplerConfig(scheme=scheme, kernels="torch", clamp=clamp,
                            micro_batch=micro)
    with api.SamplingSession(pm, cfg, device="cpu", mesh=mesh) as s:
        assert s.plan(N).clamp == WC.normalize_clamp(clamp)
        got = s.sample(N, prng.key(3))
        lp = s.stats["log_prob"]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(lp, want_lp, **TOL[torch.float64])
    with GammaStore(root, torch.float64, torch.float64) as store, \
            api.SamplingSession(store, api.SamplerConfig(
                scheme=scheme, kernels="torch", clamp=clamp,
                micro_batch=micro, segment_len=3), mesh=mesh,
                device="cpu") as s:
        assert s.plan(N).backend == "streamed"
        np.testing.assert_array_equal(s.sample(N, prng.key(3)), want)
        np.testing.assert_array_equal(s.stats["log_prob"], lp)
        assert s.stats["segments"] == 4


@pytest.mark.parametrize("scheme", ["seq", "dp"])
@pytest.mark.parametrize("empty", [None, {}, []])
def test_empty_clamp_is_the_unclamped_walk(chain, one_rank, scheme, empty):
    _, pm, _ = chain
    mesh = one_rank if scheme == "dp" else None
    with api.SamplingSession(pm, api.SamplerConfig(
            scheme=scheme, kernels="torch"), device="cpu", mesh=mesh) as s:
        base = s.sample(N, prng.key(3))
    with api.SamplingSession(pm, api.SamplerConfig(
            scheme=scheme, kernels="torch", clamp=empty), device="cpu",
            mesh=mesh) as s:
        assert s.plan(N).clamp is None
        np.testing.assert_array_equal(s.sample(N, prng.key(3)), base)
        assert "log_prob" not in s.stats    # the unclamped path ran


STREAM_CASES = {"linear": ("linear", 3, None, {2: 1, 7: 0}),
                "linear-micro": ("linear", 4, 8, {0: 2, 9: 1}),
                "linear-per-sample": ("linear", 3, None,
                                      {4: [i % 3 for i in range(N)]}),
                "born": ("born", 2, None, {1: 1, 4: 0})}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streamed_engine_matches_jax(chain, tmp_path, case):
    """The port's engine and the JAX package's walk one store."""
    semantics, seg, micro, clamp = STREAM_CASES[case]
    if semantics == "born":
        root = str(tmp_path / "born")
        with JStore(root, storage_dtype=jnp.complex128,
                    compute_dtype=jnp.complex128) as st:
            st.write_mps(JM.random_born_mps(jax.random.key(2), 7, 4, 2))
        dt = (jnp.complex128, torch.complex128)
    else:
        root, dt = chain[2], (jnp.float64, torch.float64)
    spec = WC.normalize_clamp(clamp)
    from repro.core import sampler as JS_
    with JEngine(JStore(root, storage_dtype=dt[0], compute_dtype=dt[0]),
                 semantics=semantics,
                 config=JS_.SamplerConfig(semantics=semantics, kernels="xla"),
                 plan=JPlan(segment_len=seg, micro_batch=micro),
                 clamp=spec) as je:
        want = je.sample(N, jax.random.key(4))
        want_lp = np.asarray(je.stats["log_prob"])
    with StreamingEngine(GammaStore(root, dt[1], dt[1]), semantics=semantics,
                         config=S.SamplerConfig(semantics=semantics,
                                                kernels="torch"),
                         plan=StreamPlan(segment_len=seg, micro_batch=micro),
                         clamp=clamp, device="cpu") as e:
        got = e.sample(N, prng.key(4))
        lp = e.stats["log_prob"]
        assert e.stats["max_live_segments"] <= 2
        e.sample(N, prng.key(4))
        np.testing.assert_array_equal(e.stats["log_prob"], lp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(lp, want_lp, **TOL[torch.float64])
    for site, v in spec:
        assert np.all(got[:, site] == np.asarray(v))


# ---------------------------------------------------------------------------
# dp and tp → dp on 4 gloo ranks against the JAX package's clamped dp cell
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
    from repro_torch.data.gamma_store import GammaStore
    from repro_torch.launch.mesh import make_mesh
    meshes = {"2x2": make_mesh(2, "cpu"), "1x4": make_mesh(4, "cpu")}
    z = np.load(work + "/chain.npz")
    mps = mps_from_arrays(z["g"], z["l"], device="cpu")
    clamps = json.load(open(work + "/clamps.json"))
    out = {}
    for name, c in json.load(open(work + "/cases.json")).items():
        cfg = dict(kernels="torch", scheme=c["scheme"],
                   measure_first=c.get("mf", False), micro_batch=c["micro"],
                   clamp={int(k): v for k, v in clamps[c["clamp"]].items()})
        with api.SamplingSession(mps, api.SamplerConfig(**cfg),
                                 mesh=meshes[c["mesh"]]) as s:
            out[name] = s.sample(c["n"], prng.key(c["seed"]))
            out[name + "/lp"] = s.stats["log_prob"]
        if c.get("stream"):
            store = GammaStore(work + "/store_fp64", torch.float64,
                               torch.float64)
            with api.SamplingSession(store, api.SamplerConfig(
                    segment_len=3, **cfg), mesh=meshes[c["mesh"]]) as s:
                out[name + "/streamed"] = s.sample(c["n"],
                                                   prng.key(c["seed"]))
                out[name + "/streamed/lp"] = s.stats["log_prob"]
            store.close()
    np.savez(f"{work}/rank{rank}.npz", **out)
    dist.destroy_process_group()
""")

_JAX_DP2 = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from jax.sharding import Mesh
    from repro import api
    from repro.core.mps import MPS
    work, n, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    z = np.load(work + "/chain.npz")
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
    out = {}
    for cname, clamp in json.load(open(work + "/clamps.json")).items():
        for micro in (None, 8):
            cfg = api.SamplerConfig(scheme="dp", kernels="xla",
                                    micro_batch=micro, clamp=clamp)
            with api.SamplingSession(MPS(z["g"], z["l"], "linear"), cfg,
                                     mesh=mesh) as s:
                out[f"{cname}/{micro}"] = s.sample(n, jax.random.key(seed))
                out[f"{cname}/{micro}/lp"] = s.stats["log_prob"]
    np.savez(work + "/jax_dp2.npz", **out)
""")

RANK_CLAMPS = {"scalar": {"1": 2, "6": 0},
               "per_sample": {"3": [(i * 7) % 3 for i in range(N)], "5": 1}}
RANK_CASES = {f"{scheme}{'_mf' if mf else ''}-{mesh}-{clamp}-{micro}": dict(
    scheme=scheme, mf=mf, mesh=mesh, clamp=clamp, micro=micro)
    for mesh in ("2x2", "1x4") for clamp in sorted(RANK_CLAMPS)
    for micro in (None, 8)
    for scheme, mf in (("dp", False), ("tp_single", False),
                       ("tp_double", False), ("tp_single", True))
    if not (micro and mf)}
for _c in ("dp-2x2-per_sample-8", "dp-1x4-scalar-None",
           "tp_double-2x2-scalar-None"):
    RANK_CASES[_c]["stream"] = True
SEED = 5


@pytest.fixture(scope="module")
def rank_cells(tmp_path_factory):
    """(port rank results, JAX dp at p₁ = 2, JAX dp at p₁ = 1)."""
    work = tmp_path_factory.mktemp("clamp_ranks")
    jm = JM.random_linear_mps(jax.random.key(8), 8, 8, 3)
    np.savez(work / "chain.npz", g=np.asarray(jm.gammas),
             l=np.asarray(jm.lambdas))
    with JStore(str(work / "store_fp64"), storage_dtype=jnp.float64,
                compute_dtype=jnp.float64) as st:
        st.write_mps(jm)
    (work / "clamps.json").write_text(json.dumps(RANK_CLAMPS))
    (work / "cases.json").write_text(json.dumps(
        {k: dict(v, n=N, seed=SEED) for k, v in RANK_CASES.items()}))
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
    # p₁ = 1: the JAX package's clamped dp cell on its one device, meanwhile
    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    dp1 = {}
    for cname, clamp in RANK_CLAMPS.items():
        for micro in (None, 8):
            with jax_api.SamplingSession(jm, jax_api.SamplerConfig(
                    scheme="dp", kernels="xla", clamp=clamp,
                    micro_batch=micro), mesh=mesh1) as js:
                dp1[f"{cname}/{micro}"] = js.sample(N, jax.random.key(SEED))
                dp1[f"{cname}/{micro}/lp"] = np.asarray(js.stats["log_prob"])
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
def test_clamped_parallel_cells_match_jax_dp(rank_cells, case):
    ranks, dp2, dp1 = rank_cells
    c = RANK_CASES[case]
    ref = dp2 if c["mesh"] == "2x2" else dp1
    want = ref[f"{c['clamp']}/{c['micro']}"]
    want_lp = ref[f"{c['clamp']}/{c['micro']}/lp"]
    for r, res in enumerate(ranks):
        for suffix in ("", "/streamed") if c.get("stream") else ("",):
            np.testing.assert_array_equal(res[case + suffix], want,
                                          err_msg=f"rank {r}{suffix}")
            np.testing.assert_allclose(res[case + suffix + "/lp"], want_lp,
                                       **TOL[torch.float64])
        for site, v in WC.normalize_clamp(RANK_CLAMPS[c["clamp"]]):
            assert np.all(res[case][:, site] == np.asarray(v))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_clamped_walks_refuse_checkpoints_and_resume(chain, tmp_path):
    _, _, root = chain
    with GammaStore(root, torch.float64, torch.float64) as store:
        cfg = api.SamplerConfig(clamp={2: 1}, segment_len=3,
                                checkpoint_dir=str(tmp_path / "ck"))
        with api.SamplingSession(store, cfg, device="cpu") as s:
            with pytest.raises(ValueError, match="clamped walks do not"):
                s.sample(8, prng.key(0))
        with api.SamplingSession(store, api.SamplerConfig(
                clamp={2: 1}, segment_len=3), device="cpu") as s:
            with pytest.raises(ValueError, match="clamped walks do not"):
                s.sample(8, prng.key(0), resume=True,
                         checkpoint_dir=str(tmp_path / "ck2"))


@pytest.mark.parametrize("fields,mesh,match", [
    ({"scheme": "baseline19", "clamp": {0: 1}}, 4, "baseline"),
    ({"clamp": {0: 1}, "compute_dtype": torch.bfloat16, "semantics":
      "born"}, None, "compute_dtype"),
    ({"clamp": {99: 0}}, None, "site 99"),
    ({"clamp": {0: 3}}, None, "outcome 3"),
    ({"clamp": {0: [1, 0]}}, None, "covers 2 samples"),
])
def test_clamped_plans_refuse_what_they_cannot_walk(fields, mesh, match):
    pm = M.random_linear_mps(prng.key(0), 4, 4, 3, device="cpu")
    m = mesh and SimpleNamespace(shape={"data": mesh, "model": 1},
                                 axis_names=("data", "model"),
                                 device=torch.device("cpu"))
    with api.SamplingSession(pm, api.SamplerConfig(**fields), device="cpu",
                             mesh=m) as s:
        with pytest.raises(ValueError, match=match):
            s.plan(8)


def test_clamped_born_walk_refuses_compute_dtype():
    _, pm, _ = _chain("born")
    _, (mask, vals) = _arrays({1: 0}, pm.n_sites, 4)
    with pytest.raises(ValueError, match="compute_dtype"):
        CL.sample_clamped(pm, 4, prng.key(0), S.SamplerConfig(
            semantics="born", kernels="torch",
            compute_dtype=torch.bfloat16), mask, vals)


# ---------------------------------------------------------------------------
# ingest
# ---------------------------------------------------------------------------

def _ragged(kind, seed=0, dims=(1, 2, 3, 2, 1), d=2):
    rng = np.random.default_rng(seed)
    if kind == "linear":
        return [rng.uniform(size=(dims[i], dims[i + 1], d))
                for i in range(len(dims) - 1)]
    return [rng.normal(size=(dims[i], dims[i + 1], d))
            + 1j * rng.normal(size=(dims[i], dims[i + 1], d))
            for i in range(len(dims) - 1)]


INGESTS = {"born-c64": ("born", None, torch.complex64, jnp.complex64),
           "born-c128": ("born", None, torch.complex128, jnp.complex128),
           "linear-bf16": ("linear", None, torch.bfloat16, jnp.bfloat16),
           "linear-fp64-lambdas": ("linear", "lambdas", torch.float64,
                                   jnp.float64)}


@pytest.mark.parametrize("case", sorted(INGESTS))
def test_ingest_gives_the_jax_chain_and_digest(case, tmp_path, monkeypatch):
    """Site files hash with their zip members' timestamps: both packages
    write under one clock reading, so equal arrays give equal digests."""
    import time
    import zipfile
    now = time.time()
    monkeypatch.setattr(zipfile, "time", SimpleNamespace(
        time=lambda: now, localtime=time.localtime))
    semantics, lam, sd, jsd = INGESTS[case]
    tensors = _ragged(semantics, seed=len(case))
    lambdas = ([np.linspace(0.5, 1.5, t.shape[1]) for t in tensors]
               if lam else None)
    npz = tmp_path / "external.npz"
    np.savez(npz, *tensors)
    store, report = IG.ingest_mps(str(npz), str(tmp_path / "port"),
                                  semantics=semantics, lambdas=lambdas,
                                  storage_dtype=sd, device="cpu")
    jstore, jreport = JIG.ingest_mps(str(npz), str(tmp_path / "jax"),
                                     semantics=semantics, lambdas=lambdas,
                                     storage_dtype=jsd)
    with store, jstore:
        assert report.to_dict() == jreport.to_dict()
        assert report.digest == store.digest() == jstore.digest()
        assert store.site_digests() == jstore.site_digests()
    mps, _ = IG.build_mps(tensors, semantics=semantics, lambdas=lambdas,
                          device="cpu")
    jm, _ = JIG.build_mps(tensors, semantics=semantics, lambdas=lambdas)
    np.testing.assert_array_equal(mps.gammas.numpy(), np.asarray(jm.gammas))
    np.testing.assert_array_equal(mps.lambdas.numpy(),
                                  np.asarray(jm.lambdas))
    np.testing.assert_allclose(M.enumerate_probabilities(mps),
                               JM.enumerate_probabilities(jm), atol=1e-12)


def _drop_last(t):
    return t[:-1]


INGEST_ERRORS = [
    ("born", _drop_last, {}), ("born", lambda t: [], {}),
    ("born", lambda t: t[:1] + [t[1][:, :, :1]] + t[2:], {}),
    ("born", lambda t: t[:1] + [np.zeros((3, 2, 2))] + t[2:], {}),
    ("born", lambda t: t, {"canonicalize": False}),
    ("born", lambda t: t, {"lambdas": [np.ones(2)] * 4}),
    ("born", lambda t: [t[0][0]] + t[1:], {}),
    ("linear", lambda t: [t[0] - 2.0] + t[1:], {}),
    ("linear", lambda t: [t[0] + 1j] + t[1:], {}),
    ("linear", lambda t: t, {"lambdas": [np.ones(2)] * 3}),
    ("linear", lambda t: t, {"lambdas": [np.ones(3)] * 4}),
    ("linear", lambda t: t, {"semantics": "other"}),
]


@pytest.mark.parametrize("i", range(len(INGEST_ERRORS)))
def test_ingest_refuses_as_jax(i):
    semantics, mutate, kw = INGEST_ERRORS[i]
    kw = dict({"semantics": semantics}, **kw)
    tensors = mutate(_ragged(semantics, seed=9))
    with pytest.raises(JIG.IngestError) as want:
        JIG.build_mps(tensors, **kw)
    with pytest.raises(IG.IngestError) as got:
        IG.build_mps(tensors, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_ingested_store_samples_through_the_session(tmp_path):
    tensors = _ragged("born", seed=3)
    store, report = IG.ingest_mps(tensors, str(tmp_path / "s"),
                                  semantics="born",
                                  storage_dtype=torch.complex128,
                                  device="cpu")
    with store, api.SamplingSession(store, api.SamplerConfig(
            semantics="born", clamp={1: 1}), device="cpu") as s:
        out = s.sample(16, prng.key(0))
        assert out.shape == (16, report.n_sites) and np.all(out[:, 1] == 1)
        assert np.all(np.isfinite(s.stats["log_prob"]))


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n,backend,scheme", [
    ("gbs", 400, "inmem", "seq"), ("conditional_marginals", 600, "inmem",
                                   "seq"),
    ("conditional_marginals", 300, "streamed", "dp"),
    ("mnist_classify_generate", 400, "inmem", "seq"),
    ("mnist_classify_generate", 200, "streamed", "seq")])
def test_scenario_scores_equal_jax(name, n, backend, scheme, tmp_path):
    path = str(tmp_path / "traj.json")
    got = SC.run_scenario(name, SC.ScenarioConfig(
        n_samples=n, seed=2, backend=backend, scheme=scheme, json_path=path,
        device="cpu"))
    jpath = str(tmp_path / "jtraj.json")
    want = JSC.run_scenario(name, JSC.ScenarioConfig(
        n_samples=n, seed=2, backend=backend, scheme=scheme, json_path=jpath))
    assert got.passed == want.passed
    np.testing.assert_allclose(got.score, want.score, rtol=1e-12, atol=1e-15)
    assert got.metrics.keys() == want.metrics.keys()
    rec, jrec = (json.load(open(p))[-1] for p in (path, jpath))
    assert rec.keys() == jrec.keys() and rec["config"] == jrec["config"]
    assert rec["bench"] == "scenario"


def test_scenario_registry_equals_jax():
    assert SC.available_scenarios() == JSC.available_scenarios()
    with pytest.raises(KeyError, match="unknown scenario"):
        SC.run_scenario("no_such_scenario")
    assert SC.ScenarioConfig().json_path is None


def test_scenarios_cli_passes_on_the_cpu(capsys):
    assert scenarios_cli.main(["--device", "cpu", "--json", ""]) == 0
    out = capsys.readouterr().out
    assert out.count("[PASS]") == 3 and "[FAIL]" not in out
    assert scenarios_cli.main(["--list"]) == 0
    assert scenarios_cli.main(["--scenario", "nope", "--device",
                               "cpu"]) == 2
