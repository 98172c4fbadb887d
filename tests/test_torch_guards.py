"""Guards of the port: it imports neither JAX nor the JAX package, its entry
points never fall back to the CPU silently, ``cuda`` never runs on CPU
tensors, unported config values say so, and the C interface the wrappers
bind matches the CUDA source."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.api.config import SamplerConfig
from repro_torch.core import mps as M
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.kernels import _build, ops, site_impls
from repro_torch.launch import sample as cli

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def _tiny_mps(device="cpu"):
    gen = torch.Generator(device=device).manual_seed(0)
    return M.random_linear_mps(3, 4, 2, generator=gen)


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


@pytest.mark.parametrize("field,value", [
    ("scheme", "dp"), ("scheme", "tp_single"), ("scheme", "tp_double"),
    ("scheme", "baseline19"), ("backend", "streamed"), ("backend", "remote"),
    ("runtime", "multihost"), ("runtime", "remote"),
    ("chi_profile", (4, 4, 4)), ("clamp", {0: 1}), ("shard", 2),
    ("compute_dtype", torch.bfloat16), ("wire_dtype", torch.bfloat16),
    ("measure_first", True), ("micro_batch", "auto"),
])
def test_unported_config_values_raise(field, value):
    session = api.SamplingSession(_tiny_mps(),
                                  SamplerConfig(**{field: value}),
                                  device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 row"):
        session.plan(8)


@pytest.mark.parametrize("flags", [
    ["--scheme", "dp"], ["--runtime", "remote"], ["--stream"],
    ["--dynamic-bond"], ["--clamp", "0=1"], ["--service"],
    ["--precision", "mxu_bf16"],
])
def test_unported_cli_flags_raise(flags, tmp_path):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md §1 row"):
        cli.main(["--sites", "3", "--chi", "4", "--out", str(tmp_path),
                  "--device", "cpu", *flags])


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
