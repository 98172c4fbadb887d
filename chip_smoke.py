#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no ``ok`` line):

1. device   — require CUDA, print the card's name and power limit, turn TF32
              off for every comparison (fp32 products stay full fp32);
2. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``;
3. small    — each kernel against its plain PyTorch version on awkward
              shapes, fp32/fp64, linear/Born, every scaling mode; the
              threefry uniforms on the card equal the CPU's bit for bit;
4. linear   — the GBS preset ``jiuzhang2`` at its full width (χ=10⁴, d=4,
              fp64) with the depth cut to M=8 sites (the in-memory slice
              holds the whole chain on the card), N=1024, walked through
              ``SamplingSession(kernels="cuda")`` and through the plain
              version; samples equal, log_scale allclose, launches = M;
5. born     — χ=10⁴, d=4, complex128, M=4, N=512, the same checks;
6. cli      — ``python -m repro_torch.launch.sample`` in a subprocess;
7. timings  — per-site kernel, plain and library times and the bound at the
              phase 4/5 shapes, printed as the ``{"kernels": [...]}`` line.

Tolerances: samples equal; env and dlog ``rtol=1e-12, atol=1e-14`` (fp64)
and ``rtol=1e-5, atol=1e-6`` (fp32), with atol taken relative to the
largest |env| (which is 1 after the per-sample rescale).
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

TOL = {torch.float64: dict(rtol=1e-12, atol=1e-14),
       torch.float32: dict(rtol=1e-5, atol=1e-6)}
SMALL_SHAPES = [(8, 4, 3), (37, 13, 5), (64, 32, 2), (1000, 257, 4)]
SCALINGS = ("none", "per_sample", "global")

# jiuzhang2 (repro/configs/gbs.py): M=144, χ=10⁴, d=4 — depth cut to fit
CHI, D = 10_000, 4
LINEAR_SITES, LINEAR_N = 8, 1024
BORN_SITES, BORN_N = 4, 512

# NVIDIA H100 SXM data sheet (dense): HBM3 bandwidth and the FP64
# tensor-core peak (the card's fp64 GEMM rate)
HBM_BYTES_PER_S = 3.35e12
PEAK_FP64_FLOPS = 67e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _phase(name: str, t0: float) -> None:
    print(f"[phase {name}] ok in {time.perf_counter() - t0:.3f} s", flush=True)


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def compare(name: str, got, want) -> float:
    """Samples equal; env and dlog within TOL; returns the max abs error."""
    e_g, s_g, d_g = got
    e_w, s_w, d_w = want
    bad = (s_g != s_w).nonzero().flatten()
    check(bad.numel() == 0, f"{name}: samples differ in {bad.numel()} rows "
          f"(first {bad[:8].tolist()})")
    check(e_g.dtype == e_w.dtype and e_g.shape == e_w.shape,
          f"{name}: env {e_g.dtype}{tuple(e_g.shape)} vs "
          f"{e_w.dtype}{tuple(e_w.shape)}")
    tol = TOL[d_w.dtype]
    scale = max(1.0, e_w.abs().max().item())
    check(torch.allclose(e_g / scale, e_w / scale, **tol),
          f"{name}: env differs (max abs "
          f"{(e_g - e_w).abs().max().item():.3e}, scale {scale:.3e})")
    check(torch.allclose(d_g, d_w, **tol),
          f"{name}: dlog differs (max abs "
          f"{(d_g - d_w).abs().max().item():.3e})")
    return max((e_g - e_w).abs().max().item(), (d_g - d_w).abs().max().item())


def operands(semantics: str, real: torch.dtype, n: int, chi: int, d: int,
             seed: int, device):
    """Seeded numpy operands: linear non-negative, Born complex Gaussian."""
    rng = np.random.default_rng(seed)
    npr = np.float64 if real == torch.float64 else np.float32
    u = rng.uniform(size=n).astype(npr)
    if semantics == "linear":
        env = rng.uniform(size=(n, chi)).astype(npr)
        gamma = rng.uniform(size=(chi, chi, d)).astype(npr)
        lam = rng.uniform(size=chi).astype(npr)
    else:
        npc = np.complex128 if real == torch.float64 else np.complex64
        env = (rng.normal(size=(n, chi))
               + 1j * rng.normal(size=(n, chi))).astype(npc)
        gamma = (rng.normal(size=(chi, chi, d))
                 + 1j * rng.normal(size=(chi, chi, d))).astype(npc)
        lam = (rng.uniform(size=chi) + 0.5).astype(npr)
    return [torch.from_numpy(a).to(device) for a in (env, gamma, lam, u)]


def time_ms(fn, reps: int) -> float:
    """Median device time of one call (CUDA events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_breakdown(fn) -> dict:
    """[device ms, launches] per CUDA kernel in one call (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():            # the device-side kernel records
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0]
        ms, count = out.get(name, (0.0, 0))
        out[name] = [ms + ev.time_range.elapsed_us() / 1e3, count + 1]
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> torch.device:
    t0 = time.perf_counter()
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    print(nvidia_smi(), flush=True)
    # comparisons on the card: no TF32 in fp32 products or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}; TF32 off", flush=True)
    _phase("device", t0)
    return torch.device("cuda", 0)


def phase_build() -> None:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"build seconds: {json.dumps(_build.build_seconds)}")
    for name in _build.SIGNATURES:
        for line in _build.ptxas_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    _phase("build", t0)


def phase_small(device) -> None:
    from repro_torch.core import prng
    from repro_torch.kernels import site_impls as SI

    t0 = time.perf_counter()
    cells = {"linear": (SI.site_step_linear_cuda, SI.site_step_linear_torch),
             "born": (SI.site_step_born_cuda, SI.site_step_born_torch)}
    worst = 0.0
    for semantics, (kernel, plain) in cells.items():
        for real in (torch.float64, torch.float32):
            for n, chi, d in SMALL_SHAPES:
                env, gamma, lam, u = operands(semantics, real, n, chi, d,
                                              seed=n + chi + d, device=device)
                for scaling in SCALINGS:
                    kw = dict(scaling=scaling, compute_dtype=None)
                    got = kernel(env, gamma, lam, u[:, None], **kw)
                    want = plain(env, gamma, lam, u[:, None], **kw)
                    torch.cuda.synchronize()
                    worst = max(worst, compare(
                        f"{semantics} {real} {(n, chi, d)} {scaling}",
                        got, want))
    print(f"kernel = plain on {2 * 2 * len(SMALL_SHAPES) * len(SCALINGS)} "
          f"small cases (max abs err {worst:.3e})")
    key = prng.fold_in(prng.key(2 ** 31 + 5), 11)
    for dt in (torch.float32, torch.float64):
        on_card = prng.uniform(key, (4099, 1), dtype=dt, device=device).cpu()
        on_cpu = prng.uniform(key, (4099, 1), dtype=dt)
        check(torch.equal(on_card.view(torch.uint8), on_cpu.view(torch.uint8)),
              f"threefry uniform {dt}: card and CPU bits differ")
    print("threefry uniform: card == CPU bit for bit (float32, float64)")
    _phase("small", t0)


def _walk(mps, n, key, kernels: str):
    """The chain walk through the core sampler (for log_scale)."""
    from repro_torch.core import sampler as S

    cfg = S.SamplerConfig(semantics=mps.semantics, kernels=kernels)
    return S.sample_chain(mps, S.init_state(mps, n, key, cfg), cfg)


def phase_full(device, semantics: str) -> dict:
    """Full-width walk through the session with the kernels, checked against
    the plain version on the card; then per-site timings on site 0."""
    from repro_torch import api
    from repro_torch.core import mps as M
    from repro_torch.core import prng
    from repro_torch.kernels import site_step as K

    t0 = time.perf_counter()
    linear = semantics == "linear"
    sites, n = (LINEAR_SITES, LINEAR_N) if linear else (BORN_SITES, BORN_N)
    name = "site_step_linear" if linear else "site_step_born"
    torch.cuda.reset_peak_memory_stats(device)
    gen = torch.Generator(device=device).manual_seed(1234)
    tb = time.perf_counter()
    if linear:
        mps = M.gbs_like_mps(sites, CHI, D, generator=gen, dtype=torch.float64)
    else:
        mps = M.random_born_mps(sites, CHI, D, generator=gen,
                                dtype=torch.complex128)
    torch.cuda.synchronize()
    chain_gb = mps.gammas.numel() * mps.gammas.element_size() / 1e9
    print(f"{semantics}: chain (M, χ, d)=({sites}, {CHI}, {D}) "
          f"{mps.gammas.dtype} {chain_gb:.3f} GB built in "
          f"{time.perf_counter() - tb:.3f} s; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(device) / 1e9:.3f} GB")

    key = prng.key(7)
    # the main path: counts set to 0 just before, read just after
    K.reset_launches()
    tw = time.perf_counter()
    with api.SamplingSession(mps, api.SamplerConfig(kernels="cuda"),
                             device=device) as session:
        samples = session.sample(n, key)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - tw
    launches = dict(K.LAUNCHES)
    print(f"{semantics}: session walk N={n} in {walk_s:.3f} s; "
          f"launches {launches}")
    check(launches[name] == sites, f"{name} launched {launches[name]} times "
          f"on the main path, expected {sites}")
    check(samples.shape == (n, sites) and samples.min() >= 0
          and samples.max() < D, f"{semantics}: bad samples")

    kern = _walk(mps, n, key, "cuda")
    plain = _walk(mps, n, key, "torch")
    torch.cuda.synchronize()
    check(np.array_equal(kern.samples.T.cpu().numpy(), samples),
          f"{semantics}: session and core walk differ")
    bad = int((kern.samples != plain.samples).sum())
    check(bad == 0, f"{semantics}: kernel and plain walks differ in {bad} "
          f"draws")
    tol = TOL[torch.float64]
    check(torch.isfinite(kern.state.log_scale).all().item()
          and torch.allclose(kern.state.log_scale, plain.state.log_scale,
                             **tol),
          f"{semantics}: log_scale differs (max abs "
          f"{(kern.state.log_scale - plain.state.log_scale).abs().max():.3e})")
    print(f"{semantics}: kernel walk == plain walk ({sites * n} draws), "
          f"log_scale max abs diff "
          f"{(kern.state.log_scale - plain.state.log_scale).abs().max():.3e}")

    # per-site timings on site 0, from the walk's final (rescaled) env
    env, gamma, lam = kern.state.env, mps.gammas[0], mps.lambdas[0]
    u = prng.uniform(prng.fold_in(key, 0), (n,), dtype=lam.dtype,
                     device=device)
    wrapper = K.site_step_linear if linear else K.site_step_born
    plain_fn = K.site_step_linear_plain if linear else K.site_step_born_plain
    err = compare(f"{semantics} full width site", wrapper(env, gamma, lam, u),
                  plain_fn(env, gamma, lam, u))
    reps = 5 if linear else 3
    ms = time_ms(lambda: wrapper(env, gamma, lam, u), reps)
    plain_ms = time_ms(lambda: plain_fn(env, gamma, lam, u), reps)
    g2 = gamma.reshape(CHI, CHI * D)
    library_ms = time_ms(lambda: torch.matmul(env, g2), reps)
    print(f"{semantics}: device ms by kernel in one {name} call "
          f"(torch.profiler): "
          f"{json.dumps(device_breakdown(lambda: wrapper(env, gamma, lam, u)))}")

    el = env.element_size()
    moved = (env.numel() * el + gamma.numel() * el + lam.numel() * 8
             + u.numel() * 8                          # inputs, read once
             + env.numel() * el + n * 8 + n * 8)      # env', samples, dlog
    if linear:   # W pass + probs + grouped collapse (1/d of the contraction)
        flops = 2 * CHI * CHI * D + 2 * n * CHI * D + 2 * n * CHI * CHI
    else:        # the full complex contraction (8 flops per complex MAC);
        flops = 8 * n * CHI * CHI * D   # env' is a gather of temp, no flops
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP64_FLOPS * 1e3
    entry = {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/site_step.cu",
        "replaces": ("src/repro/kernels/site_step.py:181" if linear
                     else "src/repro/kernels/site_step.py:303"),
        "launches": launches[name], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
        "shape": {"n": n, "chi": CHI, "d": D, "dtype": str(env.dtype)},
        "walk_s": walk_s, "sites": sites,
    }
    print(f"{semantics}: per site ms={ms:.3f} plain_ms={plain_ms:.3f} "
          f"library_ms={library_ms:.3f} bound_ms={entry['bound_ms']:.3f} "
          f"({entry['bound_by']}: {moved / 1e9:.3f} GB, "
          f"{flops / 1e12:.4f} TFLOP)")
    del mps, kern, plain, env, gamma, lam, u, g2
    torch.cuda.empty_cache()
    _phase(semantics, t0)
    return entry


def phase_cli() -> None:
    t0 = time.perf_counter()
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as out:
        env = dict(os.environ, PYTHONPATH=str(SRC))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.sample", "--sites",
             "8", "--chi", "256", "--d", "4", "--samples", "4096",
             "--macro-batches", "2", "--out", out], cwd=ROOT, env=env,
            capture_output=True, text=True, timeout=600)
        print(proc.stdout[-1500:])
        check(proc.returncode == 0,
              f"CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        for b in (0, 1):
            check(os.path.exists(os.path.join(out, f"batch_{b:05d}.npy")),
                  f"CLI wrote no batch {b}")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("kernel launches:")]
        check(len(line) == 1, "CLI printed no launch counts")
        counts = json.loads(line[0].split(":", 1)[1])
        check(counts["site_step_linear"] > 0,
              f"CLI launched no kernel: {counts}")
    _phase("cli", t0)


def main() -> int:
    device = phase_device()
    sys.path.insert(0, str(SRC))
    phase_build()
    phase_small(device)
    entries = [phase_full(device, "linear"), phase_full(device, "born")]
    phase_cli()
    print("kernels:", json.dumps(entries))
    print(nvidia_smi())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
