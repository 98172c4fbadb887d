"""Seed parity at the command line (paper §4.1): the port's chain builders
draw the JAX builders' chains from the same key, and the two sampling CLIs
write the same batch files for the same flags.

The JAX CLI does not turn on x64 itself, so it runs here with
``JAX_ENABLE_X64=1``: its ``--precision fp64`` is then fp64, as the port's
is.  Builders: ``rtol=1e-15`` (each row is normalised by a sum taken in
another order); Λ is exact.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core import mps as JM
from repro_torch.core import mps as M
from repro_torch.core import prng

ROOT = Path(__file__).resolve().parents[1]
FLAGS = ["--sites", "5", "--chi", "8", "--d", "3", "--samples", "64",
         "--macro-batches", "2"]


@pytest.mark.parametrize("seed", [0, 2 ** 33 + 5])
@pytest.mark.parametrize("shape", [(5, 8, 3), (2, 40, 4)])
@pytest.mark.parametrize("builder", ["random_linear_mps", "gbs_like_mps"])
def test_builders_match_jax(builder, shape, seed, monkeypatch):
    kw = {"decay": 0.3} if builder == "random_linear_mps" else {}
    want = getattr(JM, builder)(jax.random.key(seed), *shape, **kw)
    got = getattr(M, builder)(prng.key(seed), *shape, device="cpu", **kw)
    np.testing.assert_allclose(got.gammas.numpy(), np.asarray(want.gammas),
                               rtol=1e-15, atol=0)
    np.testing.assert_array_equal(got.lambdas.numpy(),
                                  np.asarray(want.lambdas))
    # drawn a few rows at a time, the chain is the same bit for bit
    monkeypatch.setattr(M, "_DRAW_CHUNK", 17)
    again = getattr(M, builder)(prng.key(seed), *shape, device="cpu", **kw)
    assert torch.equal(again.gammas, got.gammas)


def test_uniform_offset_is_a_slice_of_the_whole_draw():
    key = prng.fold_in(prng.key(3), 9)
    whole = prng.uniform(key, (6, 7), dtype=torch.float32)
    part = prng.uniform(key, (2, 7), dtype=torch.float32, offset=3 * 7)
    assert torch.equal(part, whole[3:5])


def _cli(module: str, out: Path, *extra: str) -> None:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               JAX_ENABLE_X64="1")
    proc = subprocess.run([sys.executable, "-m", module, *FLAGS, "--out",
                           str(out), *extra], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]


@pytest.mark.parametrize("precision,scheme", [
    pytest.param("fp64", "dp", id="fp64"),
    pytest.param("fp32", "dp", id="fp32"),
    pytest.param("mxu_bf16", "dp", id="mxu_bf16-dp"),
    pytest.param("mxu_bf16", "seq", id="mxu_bf16-seq")])
def test_cli_batch_files_match_jax(tmp_path, precision, scheme):
    """``--precision mxu_bf16`` casts the fp64-built chain to fp32 and walks
    it with bf16 GEMM inputs in both CLIs.  The batch files hold the
    samples (no log_scale); ``stats.json``'s per-site means follow them."""
    flags = ("--precision", precision, "--scheme", scheme)
    _cli("repro.launch.sample", tmp_path / "jax", *flags)
    _cli("repro_torch.launch.sample", tmp_path / "port", "--device", "cpu",
         *flags)
    for b in range(2):
        name = f"batch_{b:05d}.npy"
        want = np.load(tmp_path / "jax" / name)
        got = np.load(tmp_path / "port" / name)
        assert got.shape == want.shape == (32, 5)
        np.testing.assert_array_equal(got, want)
    stats = [json.loads((tmp_path / side / "stats.json").read_text())
             for side in ("jax", "port")]
    for k in ("n_samples", "mean_photon_min", "mean_photon_max"):
        assert stats[0][k] == stats[1][k], k
