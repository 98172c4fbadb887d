"""Guards of the port: it imports neither JAX, the JAX package nor its
benchmarks, its entry points never fall back to the CPU silently, ``cuda``
never runs on CPU tensors, unported config values say so (and the ported
ones resolve), and the C interface the wrappers bind matches the CUDA
source."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch import api, configs
from repro_torch.api.config import SamplerConfig
from repro_torch.core import mps as M
from repro_torch.core import perfmodel as PM
from repro_torch.core import prng
from repro_torch.core import sampler as S
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, ops, site_impls
from repro_torch.launch import sample as cli
from repro_torch.launch import serve_lm
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_import_scan_covers_every_package():
    scanned = {p.parent.name for p in PORT_FILES}
    assert {"shard", "serve", "api", "engine", "launch", "optim",
            "checkpoint", "data"} <= scanned
    launch = {p.name for p in PORT_FILES if p.parent.name == "launch"}
    assert {"costs.py", "dryrun.py", "report.py"} <= launch


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "benchmarks"), (path,
                                                                     mod)


def _tiny_mps(device="cpu"):
    return M.random_linear_mps(prng.key(0), 3, 4, 2, device=device)


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_gpu(no_gpu, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.SamplingSession(_tiny_mps())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--sites", "3", "--chi", "4", "--samples", "8",
                  "--macro-batches", "1", "--out", str(tmp_path)])
    assert resolve_device("cpu") == torch.device("cpu")


def test_lm_entry_points_raise_without_gpu(no_gpu, capsys):
    """The LM serving CLI and the model constructors target the card by
    default and raise without one; ``--device cpu`` serves on the CPU."""
    argv = ["--arch", "granite-3-2b", "--requests", "5", "--batch", "2",
            "--max-new", "4"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(argv)
    cfg = configs.get_smoke_config("granite-3-2b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_decode_state(cfg, 2, 8)
    serve_lm.main([*argv, "--device", "cpu"])
    assert "served 5 requests" in capsys.readouterr().out


def test_cuda_kernels_on_cpu_tensors_raise():
    mps = _tiny_mps()
    env = torch.zeros((8, 4), dtype=torch.float64)
    env[:, 0] = 1.0
    u = prng.uniform(prng.key(0), (8, 1))
    with pytest.raises(ValueError, match="cuda"):
        ops.site_step(env, mps.gammas[0], mps.lambdas[0], u, kernels="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        site_impls.site_step_linear_cuda(env, mps.gammas[0], mps.lambdas[0],
                                         u, scaling="per_sample",
                                         compute_dtype=None)
    session = api.SamplingSession(mps, SamplerConfig(kernels="cuda"),
                                  device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        session.sample(8, prng.key(0))


def _mesh(p1: int, p2: int):
    """What planning reads of a mesh (no process group is needed to plan)."""
    return SimpleNamespace(shape={"data": p1, "model": p2},
                           axis_names=("data", "model"),
                           device=torch.device("cpu"))


def _one_process_multihost(make):
    """The JAX package's own error: ``multihost`` needs ≥ 2 processes (the
    session resolves its runtime when it is made)."""
    with pytest.raises(ValueError, match="≥ 2 processes"):
        make()


def _remote_loopback(make):
    """backend='remote' on the local runtime: the payload runs in this
    process and gives the in-memory walk's samples."""
    session = make()
    plan = session.plan(8)
    assert (plan.backend, plan.runtime, plan.scheme) == ("remote", "local",
                                                         "seq")
    want = api.SamplingSession(_tiny_mps(), SamplerConfig(kernels="torch"),
                               device="cpu").sample(8, prng.key(0))
    np.testing.assert_array_equal(session.sample(8, prng.key(0)), want)
    assert session.stats["runtime_dispatches"] == 1
    session.close()


def _remote_runtime(make):
    """runtime='remote' resolves the remote data plane (the walk itself,
    in a worker process, is tests/test_torch_fleet.py's)."""
    with make() as session:
        plan = session.plan(8)
        assert (plan.backend, plan.runtime) == ("remote", "remote")
        assert isinstance(session.runtime, api.RemoteRuntime)
        assert session.runtime.worker is None    # spawned on first submit


def _sharded(make):
    """The JAX package's own error: sharding distributes the streamed
    walk, and an in-memory source has none."""
    with make() as session, pytest.raises(
            ValueError, match="needs backend='streamed'"):
        session.plan(8)


@pytest.mark.parametrize("fields,mesh,check", [
    ({"scheme": "dp", "runtime": "multihost"}, (1, 1),
     _one_process_multihost),
    ({"backend": "remote"}, None, _remote_loopback),
    ({"runtime": "multihost"}, None, _one_process_multihost),
    ({"runtime": "remote"}, None, _remote_runtime),
    ({"shard": 2}, None, _sharded),
    ({"scheme": "tp_single", "shard": 2}, (1, 1), _sharded),
], ids=["scheme=dp-runtime=multihost-mesh(1, 1)", "backend=remote-meshNone",
        "runtime=multihost-meshNone", "runtime=remote-meshNone",
        "shard=2-meshNone", "scheme=tp_single-shard=2-mesh(1, 1)"])
def test_unported_config_values_raise(fields, mesh, check):
    """The config values ROADMAP.md §1 row 10 named: the runtimes, the
    remote plane and the sharded plane now hold their ported path, or the
    JAX package's own error."""
    check(lambda: api.SamplingSession(_tiny_mps(), SamplerConfig(**fields),
                                      device="cpu",
                                      mesh=mesh and _mesh(*mesh)))


def _chain4():
    return M.random_linear_mps(prng.key(0), 4, 4, 2, device="cpu")


def _auto_tp(plan):
    w = PM.Workload(n_samples=8, n_sites=4, chi=4, d=2, macro_batch=8,
                    micro_batch=8)
    assert plan.scheme == "tp_" + PM.choose_tp_scheme(w, PM.H100, 2)
    assert plan.pconfig.scheme == plan.scheme and plan.p2 == 2


def _staged_tp(plan):
    assert (plan.scheme, plan.stages) == ("tp_single", ((0, 4, 4),))
    assert plan.chi_profile == (4, 4, 4, 4)


def _streamed(plan, session):
    assert (plan.backend, plan.segment_len) == ("streamed", 4)
    got = session.sample(8, prng.key(0))
    want = api.SamplingSession(_chain4(), SamplerConfig(kernels="torch"),
                               device="cpu").sample(8, prng.key(0))
    np.testing.assert_array_equal(got, want)
    assert session.stats["segments"] == 1


def _staged_seq(plan, session):
    assert (plan.scheme, plan.stages) == ("seq", ((0, 4, 4),))
    want = api.SamplingSession(_chain4(), SamplerConfig(kernels="torch"),
                               device="cpu").sample(8, prng.key(0))
    np.testing.assert_array_equal(session.sample(8, prng.key(0)), want)


def _auto_micro(plan, session):
    assert plan.micro_batch is None          # the whole batch fits
    tight = api.SamplingSession(_chain4(), SamplerConfig(
        micro_batch="auto", device_budget=2 * 4 * 2 * 8 * 10), device="cpu")
    assert tight.plan(8).micro_batch == 2
    np.testing.assert_array_equal(
        tight.sample(8, prng.key(0)),
        S.sample_batched(_chain4(), 8, prng.key(0), 2).numpy())


def _clamped_dp(plan):
    assert (plan.scheme, plan.clamp) == ("dp", ((0, 1),))
    assert plan.pconfig.scheme == "dp"


def _clamped_seq(plan, session):
    from repro_torch.core import clamped as CL

    assert (plan.scheme, plan.clamp) == ("seq", ((0, 1),))
    got = session.sample(8, prng.key(0))
    mask = np.array([True, False, False, False])
    vals = np.ones((4, 8), dtype=np.int32)
    want, lp = CL.sample_clamped(_chain4(), 8, prng.key(0),
                                 S.SamplerConfig(kernels="torch"), mask, vals)
    np.testing.assert_array_equal(got, want.numpy())
    assert (got[:, 0] == 1).all()
    np.testing.assert_array_equal(session.stats["log_prob"], lp.numpy())


@pytest.mark.parametrize("fields,mesh,check", [
    ({"scheme": "auto"}, (1, 2), _auto_tp),
    ({"scheme": "tp_single", "chi_profile": (4, 4, 4, 4)}, (1, 1),
     _staged_tp),
    ({"backend": "streamed"}, None, _streamed),
    ({"chi_profile": (4, 4, 4, 4)}, None, _staged_seq),
    ({"micro_batch": "auto"}, None, _auto_micro),
    ({"scheme": "dp", "clamp": {0: 1}}, (1, 1), _clamped_dp),
    ({"clamp": {0: 1}}, None, _clamped_seq),
], ids=["scheme=auto-mesh(1, 2)", "scheme=tp_single-chi_profile",
        "backend=streamed", "chi_profile", "micro_batch=auto",
        "scheme=dp-clamp={0: 1}", "clamp={0: 1}"])
def test_ported_config_values_resolve(fields, mesh, check):
    """What ROADMAP.md §1 rows 8, 9 and 12 ported: the Eq. 7 selector,
    dynamic χ, the streamed backend, the Eq. 3 micro batch and the clamp,
    as plans and, where a walk needs no mesh, as CPU runs against the plain
    walk."""
    with api.SamplingSession(_chain4(), SamplerConfig(**fields),
                             device="cpu", mesh=mesh and _mesh(*mesh)) as s:
        plan = s.plan(8)
        if mesh:
            check(plan)
        else:
            check(plan, s)


def test_a_second_data_axis_is_unported():
    """A second data axis (the JAX package's "pod") is ported: the schemes
    split the batch over the flattened ("pod", "data") line.  On a
    one-rank ("pod", "data", "model") mesh the dp walk is the one-axis
    mesh's (4 ranks: tests/test_torch_shard.py)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import (init_distributed, make_mesh,
                                         make_pod_mesh)
    created = init_distributed(torch.device("cpu"))
    try:
        pod = make_pod_mesh(1, device="cpu")
        assert pod.axis_names == ("pod", "data", "model")
        out = {}
        for name, mesh in (("pod", pod), ("flat", make_mesh(1, "cpu"))):
            with api.SamplingSession(_tiny_mps(), SamplerConfig(
                    scheme="dp", kernels="torch"), device="cpu",
                    mesh=mesh) as session:
                out[name] = session.sample(8, prng.key(0))
                axes = session.plan(8).pconfig.data_axes
                assert axes == (("pod", "data") if name == "pod"
                                else ("data",))
        np.testing.assert_array_equal(out["pod"], out["flat"])
        with pytest.raises(ValueError, match="flattened"):
            pod.group(("data", "model"))
    finally:
        if created:
            dist.destroy_process_group()


@pytest.mark.parametrize("pods,data,model", [(2, 1, 1), (2, 2, 2)],
                         ids=["2x1x1", "2x2x2"])
def test_a_pod_mesh_plans(pods, data, model):
    """A ("pod", "data", "model") mesh plans as the JAX package's: p₁ is
    the product of the data axes, and the placement names both."""
    mesh = SimpleNamespace(shape={"pod": pods, "data": data, "model": model},
                           axis_names=("pod", "data", "model"),
                           device=torch.device("cpu"))
    session = api.SamplingSession(
        M.random_linear_mps(prng.key(0), 4, 4, 2, device="cpu"),
        SamplerConfig(scheme="dp" if model == 1 else "tp_single"),
        device="cpu", mesh=mesh)
    plan = session.plan(8)
    assert (plan.p1, plan.p2) == (pods * data, model)
    assert plan.pconfig.data_axes == ("pod", "data")


@pytest.mark.parametrize("fields,mesh,scheme", [
    ({"scheme": "dp"}, (2, 1), "dp"),
    ({"scheme": "tp_single"}, (1, 2), "tp_single"),
    ({"scheme": "tp_double"}, (1, 2), "tp_double"),
    ({"scheme": "baseline19"}, (4, 1), "baseline19"),
    ({"scheme": "tp_single", "wire_dtype": torch.bfloat16}, (2, 2),
     "tp_single"),
    ({"scheme": "tp_single", "measure_first": True}, (1, 2), "tp_single"),
    ({}, (2, 1), "dp"),
    ({}, (1, 1), "seq"),
], ids=["dp", "tp_single", "tp_double", "baseline19", "wire_dtype",
        "measure_first", "auto-dp", "auto-seq"])
def test_parallel_config_values_resolve(fields, mesh, scheme):
    """The schemes of core/parallel.py plan on a mesh: p₁, p₂ and the
    placement as the JAX package resolves them."""
    mps = M.random_linear_mps(prng.key(0), 4, 4, 2, device="cpu")
    session = api.SamplingSession(mps, SamplerConfig(**fields),
                                  device="cpu", mesh=_mesh(*mesh))
    plan = session.plan(8)
    assert (plan.scheme, plan.p1, plan.p2) == (scheme, *mesh)
    if scheme in ("dp", "tp_single", "tp_double"):
        assert plan.pconfig.scheme == scheme
        assert plan.pconfig.wire_dtype == fields.get("wire_dtype")
        assert plan.pconfig.measure_first == fields.get("measure_first",
                                                        False)
    else:
        assert plan.pconfig is None


@pytest.mark.parametrize("fields,mesh,match", [
    ({"scheme": "dp"}, None, "needs a mesh"),
    ({"scheme": "tp_single"}, (1, 3), "does not divide"),
    ({"scheme": "dp"}, (3, 1), "must divide"),
    ({"scheme": "baseline19", "micro_batch": 4}, (2, 1), "micro batching"),
])
def test_bad_parallel_requests_raise(fields, mesh, match):
    session = api.SamplingSession(_tiny_mps(), SamplerConfig(**fields),
                                  device="cpu",
                                  mesh=mesh and _mesh(*mesh))
    with pytest.raises(ValueError, match=match):
        session.plan(8)


@pytest.mark.parametrize("flags", [
    ["--runtime", "remote"], ["--service"],
])
def test_unported_cli_flags_raise(flags, tmp_path, capsys):
    """The CLI flags ROADMAP.md §1 row 10a ported: ``--runtime remote`` (a
    CPU worker process) and ``--service`` write the plain run's batch
    files (a worker places its walk itself: seq, as the JAX package's CLI
    overrides the scheme for it)."""
    argv = ["--sites", "3", "--chi", "4", "--samples", "32",
            "--macro-batches", "2", "--device", "cpu"]
    plain = ["--scheme", "seq"] if flags[0] == "--runtime" else []
    cli.main([*argv, "--out", str(tmp_path / "plain"), *plain])
    cli.main([*argv, "--out", str(tmp_path / "flag"), *flags])
    for b in range(2):
        np.testing.assert_array_equal(
            np.load(tmp_path / "flag" / f"batch_{b:05d}.npy"),
            np.load(tmp_path / "plain" / f"batch_{b:05d}.npy"))
    out = capsys.readouterr().out
    if flags[0] == "--service":
        assert "[service] 2/2 batches" in out
    else:
        assert '"dispatches": 2' in out


@pytest.mark.parametrize("flags", [
    ["--dynamic-bond", "--scheme", "tp_double"], ["--stream"],
    ["--dynamic-bond"], ["--clamp", "0=1"],
])
def test_ported_cli_flags_run(flags, tmp_path, capsys):
    """``--stream``, ``--dynamic-bond`` and ``--clamp`` walk on the CPU;
    the area-law profile's first stage is one site, which tp_double cannot
    pair, so that plan is refused as the JAX package refuses it."""
    argv = ["--sites", "4", "--chi", "4", "--samples", "16",
            "--macro-batches", "2", "--out", str(tmp_path), "--device",
            "cpu", *flags]
    if "tp_double" in flags:
        with pytest.raises(ValueError, match="boundaries must be even"):
            cli.main(argv)
        return
    cli.main(argv)
    out = capsys.readouterr().out
    assert np.load(tmp_path / "batch_00001.npy").shape == (8, 4)
    assert ("'backend': 'streamed'" in out) == ("--stream" in flags)
    assert ("table1:" in out) == ("--dynamic-bond" in flags)
    assert ("clamp log_prob: n=16" in out) == ("--clamp" in flags)
    if "--clamp" in flags:
        assert (np.load(tmp_path / "batch_00000.npy")[:, 0] == 1).all()
        assert not (tmp_path / "chain_ckpt").exists()


def test_cli_runs_and_resumes_on_cpu(tmp_path):
    argv = ["--sites", "4", "--chi", "6", "--d", "3", "--samples", "32",
            "--macro-batches", "2", "--out", str(tmp_path), "--device", "cpu"]
    cli.main(argv)
    first = np.load(tmp_path / "batch_00001.npy")
    (tmp_path / "batch_00001.npy").unlink()
    cli.main(argv)                       # regenerates only batch 1
    np.testing.assert_array_equal(np.load(tmp_path / "batch_00001.npy"),
                                  first)
    assert (tmp_path / "stats.json").exists()


def test_c_interface_matches_the_cuda_source():
    """Every C entry the wrappers bind exists in the source with as many
    parameters as its ctypes argtypes (the sandbox has no nvcc to check)."""
    for name, sigs in _build.SIGNATURES.items():
        src = (_build.CSRC / f"{name}.cu").read_text()
        extern = src[src.index('extern "C"'):]
        found = {m.group(1): m.group(2) for m in re.finditer(
            r"^int (fastmps_\w+)\(([^)]*)\)", extern, re.M)}
        assert set(found) == set(sigs)
        for fn, argtypes in sigs.items():
            params = [p for p in found[fn].split(",") if p.strip()]
            assert len(params) == len(argtypes), fn


def test_ptxas_log_parser():
    """Registers and spill bytes per kernel from an ``nvcc -Xptxas -v``
    log, keyed by the short name ``chip_smoke.py`` prints and checks."""
    fn = ("_ZN36_GLOBAL__N__f191fb7b_4_k_cu_c950e9fc15flash_tc_kernelILi64EE"
          "EvPK13__nv_bfloat16S3_S3_PS1_iiiii")
    other = "_ZN36_GLOBAL__N__6a00b96d_4_k_cu_64f50b2913bucket_kernelEPKiiiPiS2_"
    log = (f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {fn}\n"
           "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill "
           "loads\n"
           "ptxas info    : Used 255 registers, 400 bytes cmem[0]\n"
           f"ptxas info    : Compiling entry function '{other}' for 'sm_90a'\n"
           "ptxas info    : Used 32 registers, 380 bytes cmem[0]\n")
    assert _build.ptxas_kernels(log) == {
        "flash_tc_kernel<64>": {"spill_stores": 12, "spill_loads": 16,
                                "registers": 255},
        "bucket_kernel": {"registers": 32}}


def test_chip_smoke_fails_without_gpu_and_alone(tmp_path):
    """With no GPU visible the script exits non-zero, in the repo and as a
    lone copy, and prints no ok line."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0, proc.stdout
        assert '"ok": true' not in proc.stdout
