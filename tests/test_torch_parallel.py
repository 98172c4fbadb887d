"""The port's DP × TP segment runner (``repro_torch.core.parallel``) against
the JAX package's (``repro.core.parallel``) on the same chains and seeds.

The JAX reference runs in one subprocess with 8 forced host devices (as
``tests/test_parallel.py`` does), on meshes of 4 of them.  The port runs as
4 gloo ranks on the CPU, each its own process joined through a ``FileStore``
in ``tmp_path``; every rank builds the meshes 2×2, 1×4 and the 4-rank [19]
ring.  Both sides load the same chains (made here by the JAX builders,
carried across as numpy) and run the cases of ``CASES``.  The two jobs run
at the same time; each has its own timeout, so a hung collective fails this
module and nothing else.

The bf16 tiers run on the same chains cast as they store them: ``mxu_bf16``
on the chain in fp32, ``store_bf16`` on its Γ in bf16 (carried as uint16
bits) with Λ in fp32, both with ``compute_dtype`` bf16, under every scheme
and in [19] (which ignores ``compute_dtype`` and walks in Γ's dtype, in
both packages).

Samples must be equal.  Env and ``log_scale`` (``sample_segment`` cases)
agree to ``rtol=1e-12, atol=1e-14`` in fp64: the contractions and the
collectives sum in other orders in the two packages; under bf16 inputs,
within 1e-5 (env is at most 1 after the per-sample rescale; the fp32 sums
of the same bf16-exact products differ in order).
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")                 # the port's ranks import it

from repro.core import mps as JM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 150
TOL = dict(rtol=1e-12, atol=1e-14)
BF16_TOL = dict(rtol=0, atol=1e-5)

# name → what to run; both sides read these (see _JAX_CHILD and _PORT_RANK)
CASES = {}
for _mesh in ("2x2", "1x4"):
    for _chain in ("linear", "born"):
        for _scheme in ("dp", "tp_single", "tp_single_mf", "tp_double"):
            if _chain == "born" and _scheme == "tp_single_mf":
                continue                 # measure-first is linear only
            CASES[f"{_scheme}-{_chain}-{_mesh}"] = dict(
                mesh=_mesh, chain=_chain, scheme=_scheme)
for _scheme in ("tp_single", "tp_single_mf", "tp_double"):
    CASES[f"{_scheme}-wire_bf16-2x2"] = dict(mesh="2x2", chain="linear",
                                             scheme=_scheme, wire=True)
CASES["tp_single-micro8-2x2"] = dict(mesh="2x2", chain="linear",
                                     scheme="tp_single", micro=8)
CASES["tp_single_mf-micro8-1x4"] = dict(mesh="1x4", chain="linear",
                                        scheme="tp_single_mf", micro=8)
CASES["dp-micro16-1x4"] = dict(mesh="1x4", chain="linear", scheme="dp",
                               micro=16)
CASES["tp_single-global-2x2"] = dict(mesh="2x2", chain="linear",
                                     scheme="tp_single", scaling="global")
for _scheme in ("dp", "tp_single", "tp_double"):
    CASES[f"segment-{_scheme}-2x2"] = dict(mesh="2x2", chain="linear",
                                           scheme=_scheme, segment=True)
CASES["segment-tp_single-born-1x4"] = dict(mesh="1x4", chain="born",
                                           scheme="tp_single", segment=True)
CASES["baseline19-linear-ring4"] = dict(mesh="ring4", chain="ring",
                                        scheme="baseline19")
CASES["baseline19-born-ring4"] = dict(mesh="ring4", chain="born",
                                      scheme="baseline19")
# the bf16 tiers: (chain, ring chain) as each stores the linear chains
TIERS = {"mxu_bf16": ("linear32", "ring32"),
         "store_bf16": ("linear_bf16", "ring_bf16")}
for _tier, (_chain, _ring) in TIERS.items():
    for _mesh in ("2x2", "1x4"):
        for _scheme in ("dp", "tp_single", "tp_single_mf", "tp_double"):
            CASES[f"{_scheme}-{_tier}-{_mesh}"] = dict(
                mesh=_mesh, chain=_chain, scheme=_scheme, compute=True)
    CASES[f"segment-tp_single-{_tier}-2x2"] = dict(
        mesh="2x2", chain=_chain, scheme="tp_single", segment=True,
        compute=True)
    CASES[f"baseline19-{_tier}-ring4"] = dict(
        mesh="ring4", chain=_ring, scheme="baseline19", compute=True)
CASES["tp_single_mf-store_bf16-micro8-1x4"] = dict(
    mesh="1x4", chain="linear_bf16", scheme="tp_single_mf", micro=8,
    compute=True)

_COMMON = """
import json, sys
import numpy as np
work = sys.argv[1]
cases = json.load(open(work + "/cases.json"))
arrays = np.load(work + "/chains.npz")
N = {"linear": 64, "born": 32, "ring": 60, "linear32": 64,
     "linear_bf16": 64}
CHAINS = {"linear": "linear", "born": "born", "ring": "linear",
          "linear32": "linear", "linear_bf16": "linear", "ring32": "linear",
          "ring_bf16": "linear"}
BF16_BITS = ("linear_bf16", "ring_bf16")   # Γ stored as uint16 bits
SPLIT = 2                               # segment cases: [0, 2) then [2, M)
out = {}
"""

_JAX_CHILD = _COMMON + textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import parallel as PP, sampler as S
    from repro.core.mps import MPS

    devs = np.array(jax.devices()[:4])
    meshes = {"2x2": Mesh(devs.reshape(2, 2), ("data", "model")),
              "1x4": Mesh(devs.reshape(1, 4), ("data", "model")),
              "ring4": Mesh(devs, ("data",))}
    import ml_dtypes
    chains = {c: MPS(jnp.asarray(arrays[c + "_g"].view(ml_dtypes.bfloat16)
                                 if c in BF16_BITS else arrays[c + "_g"]),
                     jnp.asarray(arrays[c + "_l"]), sem)
              for c, sem in CHAINS.items()}
    key = jax.random.key(7)
    for name, c in cases.items():
        mesh, mps = meshes[c["mesh"]], chains[c["chain"]]
        cfg = S.SamplerConfig(semantics=mps.semantics, kernels="xla",
                              scaling=c.get("scaling", "per_sample"),
                              compute_dtype=jnp.bfloat16 if c.get("compute")
                              else None)
        n = N[c["chain"]] if c["scheme"] != "baseline19" else N["ring"]
        if c["scheme"] == "baseline19":
            out[name + "/samples"] = PP._baseline19_sample(
                mesh, mps, n, key, cfg)
            continue
        pc = PP.ParallelConfig(
            scheme=c["scheme"].replace("_mf", ""),
            measure_first=c["scheme"].endswith("_mf"),
            wire_dtype=jnp.bfloat16 if c.get("wire") else None,
            micro_batch=c.get("micro"))
        if not c.get("segment"):
            out[name + "/samples"] = PP._multilevel_sample(mesh, mps, n, key,
                                                           pc, cfg)
            continue
        env = PP.segment_env_init(n, mps.chi, mps.gammas.dtype)
        ls = None
        for s0, s1 in ((0, SPLIT), (SPLIT, mps.n_sites)):
            seg = MPS(mps.gammas[s0:s1], mps.lambdas[s0:s1], mps.semantics)
            smp, env, ls = PP.sample_segment(mesh, seg, env, key, s0, pc, cfg,
                                             log_scale=ls)
            out[f"{name}/samples{s0}"] = smp
            out[f"{name}/env{s0}"] = env
            out[f"{name}/log_scale{s0}"] = ls
    np.savez(work + "/jax.npz",
             **{k: np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                              else v) for k, v in out.items()})
""")

_PORT_RANK = _COMMON + textwrap.dedent("""
    import torch
    import torch.distributed as dist
    rank = int(sys.argv[2])
    dist.init_process_group("gloo", store=dist.FileStore(work + "/store", 4),
                            rank=rank, world_size=4)
    from repro_torch.convert import mps_from_arrays
    from repro_torch.core import parallel as PP, prng, sampler as S
    from repro_torch.core.mps import MPS
    from repro_torch.launch.mesh import device_mesh, make_mesh

    meshes = {"2x2": make_mesh(2, "cpu"), "1x4": make_mesh(4, "cpu"),
              "ring4": device_mesh((4,), ("data",), "cpu")}
    chains = {c: mps_from_arrays(arrays[c + "_g"], arrays[c + "_l"], sem,
                                 device="cpu",
                                 gammas_view_as=torch.bfloat16
                                 if c in BF16_BITS else None)
              for c, sem in CHAINS.items()}
    key = prng.key(7)
    for name, c in cases.items():
        mesh, mps = meshes[c["mesh"]], chains[c["chain"]]
        cfg = S.SamplerConfig(semantics=mps.semantics, kernels="torch",
                              scaling=c.get("scaling", "per_sample"),
                              compute_dtype=torch.bfloat16 if c.get("compute")
                              else None)
        n = N[c["chain"]] if c["scheme"] != "baseline19" else N["ring"]
        if c["scheme"] == "baseline19":
            out[name + "/samples"] = PP._baseline19_sample(
                mesh, mps, n, key, cfg)
            continue
        pc = PP.ParallelConfig(
            scheme=c["scheme"].replace("_mf", ""),
            measure_first=c["scheme"].endswith("_mf"),
            wire_dtype=torch.bfloat16 if c.get("wire") else None,
            micro_batch=c.get("micro"))
        if not c.get("segment"):
            out[name + "/samples"] = PP._multilevel_sample(mesh, mps, n, key,
                                                           pc, cfg)
            continue
        env = PP.segment_env_init(n, mps.chi, mps.gammas.dtype, "cpu")
        ls = None
        for s0, s1 in ((0, SPLIT), (SPLIT, mps.n_sites)):
            seg = MPS(mps.gammas[s0:s1], mps.lambdas[s0:s1], mps.semantics)
            smp, env, ls = PP.sample_segment(mesh, seg, env, key, s0, pc, cfg,
                                             log_scale=ls)
            out[f"{name}/samples{s0}"] = smp
            out[f"{name}/env{s0}"] = env
            out[f"{name}/log_scale{s0}"] = ls

    # the same cases on this rank's tiles alone (parallel.rank_chain), and
    # with the result kept sharded (tiles in, the shards out, no gather)
    import torch.distributed as D
    for name, c in cases.items():
        if c["scheme"] == "baseline19":
            continue
        mesh, mps = meshes[c["mesh"]], chains[c["chain"]]
        cfg = S.SamplerConfig(semantics=mps.semantics, kernels="torch",
                              scaling=c.get("scaling", "per_sample"),
                              compute_dtype=torch.bfloat16 if c.get("compute")
                              else None)
        pc = PP.ParallelConfig(
            scheme=c["scheme"].replace("_mf", ""),
            measure_first=c["scheme"].endswith("_mf"),
            wire_dtype=torch.bfloat16 if c.get("wire") else None,
            micro_batch=c.get("micro"))
        n = N[c["chain"]]
        out[f"coords:{name}"] = torch.tensor(
            [D.get_rank(mesh.group("data")), D.get_rank(mesh.group("model"))])
        if not c.get("segment"):
            for how, sharded in (("tiles", False), ("shard", True)):
                out[f"{how}:{name}/samples"] = PP._multilevel_sample(
                    mesh, PP.rank_chain(mesh, mps, pc), n, key, pc, cfg,
                    sharded=sharded)
            continue
        for how, sharded in (("tiles", False), ("shard", True)):
            env = (PP.segment_env_shard(mesh, pc, n, mps.chi,
                                        mps.gammas.dtype, "cpu") if sharded
                   else PP.segment_env_init(n, mps.chi, mps.gammas.dtype,
                                            "cpu"))
            ls = None
            for s0, s1 in ((0, SPLIT), (SPLIT, mps.n_sites)):
                seg = PP.rank_chain(mesh, MPS(mps.gammas[s0:s1],
                                              mps.lambdas[s0:s1],
                                              mps.semantics), pc)
                smp, env, ls = PP.sample_segment(mesh, seg, env, key, s0, pc,
                                                 cfg, log_scale=ls,
                                                 sharded=sharded)
                out[f"{how}:{name}/samples{s0}"] = smp
                out[f"{how}:{name}/env{s0}"] = env
                out[f"{how}:{name}/log_scale{s0}"] = ls
    np.savez(f"{work}/port{rank}.npz",
             **{k: v.float().numpy() if v.dtype == torch.bfloat16
                else v.numpy() for k, v in out.items()})
    dist.destroy_process_group()
""")


def _spawn(code: str, work: Path, *args: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-c", code, str(work), *args],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _join(proc: subprocess.Popen, what: str) -> None:
    try:
        log, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        log, _ = proc.communicate()
        pytest.fail(f"{what} did not finish in {TIMEOUT} s:\n{log[-3000:]}")
    assert proc.returncode == 0, f"{what} failed:\n{log[-5000:]}"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(jax, [port rank 0, ..., port rank 3]) dicts of result arrays, keyed
    '<case>/<what>'."""
    work = tmp_path_factory.mktemp("torch_parallel")
    chains = {"linear": JM.random_linear_mps(jax.random.key(0), 6, 8, 3),
              "born": JM.random_born_mps(jax.random.key(2), 4, 8, 2),
              "ring": JM.random_linear_mps(jax.random.key(1), 4, 8, 3)}
    arrays = {f"{c}_{part}": np.asarray(getattr(m, attr))
              for c, m in chains.items()
              for part, attr in (("g", "gammas"), ("l", "lambdas"))}
    for c in ("linear", "ring"):         # the tiers' storage of each chain
        g, lam = arrays[c + "_g"], arrays[c + "_l"].astype(np.float32)
        arrays.update({c + "32_g": g.astype(np.float32), c + "32_l": lam,
                       c + "_bf16_g": np.asarray(
                           jnp.asarray(g).astype(jnp.bfloat16)).view(
                               np.uint16),
                       c + "_bf16_l": lam})
    np.savez(work / "chains.npz", **arrays)
    (work / "cases.json").write_text(json.dumps(CASES))
    procs = [("the JAX reference", _spawn(_JAX_CHILD, work))]
    procs += [(f"port rank {r}", _spawn(_PORT_RANK, work, str(r)))
              for r in range(4)]
    for what, proc in procs:
        _join(proc, what)
    return (dict(np.load(work / "jax.npz")),
            [dict(np.load(work / f"port{r}.npz")) for r in range(4)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_matches_jax(results, case):
    want, got = results[0], results[1][0]
    keys = sorted(k for k in want if k.startswith(case + "/"))
    assert keys and keys == sorted(k for k in got if k.startswith(case + "/"))
    tol = BF16_TOL if CASES[case].get("compute") else TOL
    for k in keys:
        if "/samples" in k:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_schemes_draw_alike(results):
    """§4.1 within the port: dp, tp_single (with and without measure-first)
    and tp_double give the same samples on one mesh and seed.  Under bf16
    inputs measure-first draws from bf16(env)·bf16(W), rounding W as the
    JAX package's measure cell does, so its probabilities differ from dp's
    by that rounding and its draws are held to the JAX package's alone."""
    got = results[1][0]
    for chain in ("linear", "born", *TIERS):
        for mesh in ("2x2", "1x4"):
            dp = got[f"dp-{chain}-{mesh}/samples"]
            for scheme in ("tp_single", "tp_single_mf", "tp_double"):
                k = f"{scheme}-{chain}-{mesh}/samples"
                if k in got and not (chain in TIERS
                                     and scheme == "tp_single_mf"):
                    np.testing.assert_array_equal(got[k], dp, err_msg=k)


def _case_keys(got, prefix, case):
    return sorted(k for k in got if k.startswith(f"{prefix}{case}/"))


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["scheme"] != "baseline19"))
def test_tile_inputs_walk_alike(results, case):
    """A rank given only its tiles of each Γ (``parallel.rank_chain``)
    returns what it returns when it cuts them from the whole chain, bit
    for bit, on every rank."""
    for got in results[1]:
        keys = _case_keys(got, "", case)
        assert keys and [f"tiles:{k}" for k in keys] == \
            _case_keys(got, "tiles:", case)
        for k in keys:
            np.testing.assert_array_equal(got[f"tiles:{k}"], got[k],
                                          err_msg=k)


def _gathered(ranks, case, k):
    """A sharded result put back together from the 4 ranks' shards by
    their (data, model) coordinates: samples and log_scale over the data
    axis, env over data × model (model under TP only)."""
    coords = {tuple(int(x) for x in r[f"coords:{case}"]): r[f"shard:{k}"]
              for r in ranks}
    p1 = max(d for d, _ in coords) + 1
    p2 = max(m for _, m in coords) + 1
    what = k.split("/")[1]
    tp = CASES[case]["scheme"] != "dp"
    rows = []
    for d in range(p1):
        if what.startswith("env") and tp:
            rows.append(np.concatenate([coords[(d, m)] for m in range(p2)],
                                       axis=1))
        else:
            for m in range(1, p2):       # replicated over "model"
                np.testing.assert_array_equal(coords[(d, m)], coords[(d, 0)],
                                              err_msg=f"{k} model {m}")
            rows.append(coords[(d, 0)])
    return np.concatenate(rows, axis=1 if what.startswith("samples")
                          and CASES[case].get("segment") else 0)


@pytest.mark.parametrize("case", sorted(c for c in CASES
                                        if CASES[c]["scheme"] != "baseline19"))
def test_sharded_return_gathers_to_the_full_result(results, case):
    """``sharded=True`` (tiles in, shards out, no all-gather at the end),
    gathered by the ranks' mesh coordinates, equals the full result bit
    for bit; every rank's shard of a replicated piece (over "model") is
    the same."""
    ranks = results[1]
    for k in _case_keys(ranks[0], "", case):
        np.testing.assert_array_equal(_gathered(ranks, case, k), ranks[0][k],
                                      err_msg=k)


def test_every_rank_holds_the_full_result(results):
    """Every rank returns the whole (N, M) array, env and log_scale, as the
    JAX controller does: ranks 1-3 equal rank 0 bit for bit."""
    ranks = results[1]
    for r in (1, 2, 3):
        assert sorted(ranks[r]) == sorted(ranks[0])
        for k, v in ranks[0].items():
            if not k.startswith(("shard:", "coords:")):
                np.testing.assert_array_equal(ranks[r][k], v,
                                              err_msg=f"{r} {k}")

