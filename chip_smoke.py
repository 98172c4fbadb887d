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
5. tp       — a one-rank NCCL process group (a ``FileStore`` under
              ``build/``) and a 1×1 mesh; on phase 4's chain, the session
              walks dp, tp_single, tp_single with measure_first and
              tp_double with ``kernels="cuda"``, each checked against the
              same walk with the plain cells (samples equal, env and
              log_scale allclose) and for its launches (M per kernel);
6. tp kernels — contract_measure, measure_probs and collapse_select called
              at the bond-shard shapes of p₂ = 4 (N = 1024), against their
              plain versions, with times and bounds;
7. born     — χ=10⁴, d=4, complex128, M=4, N=512, the same checks as 4,
              then a Born tp_double walk on the mesh against the dp walk;
8. cli      — ``python -m repro_torch.launch.sample`` in a subprocess;
9. timings  — per-site kernel, plain and library times and the bound at the
              phase 4/7 shapes; with phase 6's, printed as the
              ``{"kernels": [...]}`` line.

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

# the tp phase: (scheme, measure_first) → kernels its walk must launch M times
TP_WALKS = {("dp", False): ("site_step_linear",),
            ("tp_single", False): ("contract_measure",),
            ("tp_single", True): ("measure_probs", "collapse_select"),
            ("tp_double", False): ("contract_measure",)}
TP_SHARDS = 4                     # the kernels are timed at p₂ = 4 shards


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


def phase_full(device, semantics: str):
    """Full-width walk through the session with the kernels, checked against
    the plain version on the card; then per-site timings on site 0.
    Returns (the kernel's entry, the chain, the walk's final env)."""
    from repro_torch import api
    from repro_torch.core import mps as M
    from repro_torch.core import prng
    from repro_torch.kernels import ops
    from repro_torch.kernels import site_step as K

    t0 = time.perf_counter()
    linear = semantics == "linear"
    sites, n = (LINEAR_SITES, LINEAR_N) if linear else (BORN_SITES, BORN_N)
    name = "site_step_linear" if linear else "site_step_born"
    torch.cuda.reset_peak_memory_stats(device)
    tb = time.perf_counter()
    if linear:
        mps = M.gbs_like_mps(prng.key(1234), sites, CHI, D,
                             dtype=torch.float64, device=device)
    else:
        gen = torch.Generator(device=device).manual_seed(1234)
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
    ops.reset_launches()
    tw = time.perf_counter()
    with api.SamplingSession(mps, api.SamplerConfig(kernels="cuda"),
                             device=device) as session:
        samples = session.sample(n, key)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - tw
    launches = ops.launch_counts()
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
    del kern, plain, gamma, lam, u, g2
    torch.cuda.empty_cache()
    _phase(semantics, t0)
    return entry, mps, env


def phase_nccl(device):
    """A real one-rank NCCL process group and a 1×1 ("data", "model") mesh
    (the card is one GPU; NCCL refuses two ranks on one)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh

    t0 = time.perf_counter()
    store = ROOT / "build" / f"nccl_store_{os.getpid()}"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    mesh = make_mesh(1, device)
    x = torch.arange(4.0, device=device)
    dist.all_reduce(x, group=mesh.group("model"))
    torch.cuda.synchronize()
    check(x.tolist() == [0.0, 1.0, 2.0, 3.0], f"NCCL all_reduce gave {x}")
    print(f"NCCL {torch.cuda.nccl.version()}: mesh {mesh.shape} on "
          f"{mesh.device}", flush=True)
    _phase("nccl", t0)
    return mesh


def _segment(mesh, mps, n, key, scheme, measure_first, kernels):
    """The segment runner over the whole chain: (samples, env, log_scale)."""
    from repro_torch.core import parallel as PP
    from repro_torch.core import sampler as S

    cfg = S.SamplerConfig(semantics=mps.semantics, kernels=kernels)
    pc = PP.ParallelConfig(scheme=scheme, measure_first=measure_first)
    env = PP.segment_env_init(n, mps.chi, mps.gammas.dtype, mps.device)
    return PP.sample_segment(mesh, mps, env, key, 0, pc, cfg)


def _same_walk(name, got, want) -> tuple[float, float]:
    """Samples equal, env and log_scale within TOL; returns the largest env
    and log_scale differences."""
    bad = int((got[0] != want[0]).sum())
    check(bad == 0, f"{name}: samples differ in {bad} draws")
    tol = TOL[torch.float64]
    env_err = (got[1] - want[1]).abs().max().item()
    ls_err = (got[2] - want[2]).abs().max().item()
    check(torch.allclose(got[1], want[1], **tol),
          f"{name}: env differs (max abs {env_err:.3e})")
    check(torch.isfinite(got[2]).all().item()
          and torch.allclose(got[2], want[2], **tol),
          f"{name}: log_scale differs (max abs {ls_err:.3e})")
    return env_err, ls_err


def phase_tp(mesh, mps) -> dict:
    """The TP schemes through the session on the mesh, kernels vs plain.
    Returns, per walk, its launch counts and wall time."""
    from repro_torch import api
    from repro_torch.core import prng
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    n, key, sites = LINEAR_N, prng.key(11), mps.n_sites
    walks, first = {}, None
    for (scheme, mf), kernels in TP_WALKS.items():
        label = scheme + ("+measure_first" if mf else "")
        cfg = api.SamplerConfig(kernels="cuda", scheme=scheme,
                                measure_first=mf)
        # the main path: counts set to 0 just before, read just after
        ops.reset_launches()
        tw = time.perf_counter()
        with api.SamplingSession(mps, cfg, mesh=mesh) as session:
            samples = session.sample(n, key)
        torch.cuda.synchronize()
        walk_s = time.perf_counter() - tw
        launches = ops.launch_counts()
        for k in kernels:
            check(launches[k] == sites, f"{label}: {k} launched "
                  f"{launches[k]} times on the walk, expected {sites}")
        kern = _segment(mesh, mps, n, key, scheme, mf, "cuda")
        plain = _segment(mesh, mps, n, key, scheme, mf, "torch")
        torch.cuda.synchronize()
        check(np.array_equal(kern[0].T.cpu().numpy(), samples),
              f"{label}: session and segment walk differ")
        env_err, ls_err = _same_walk(label, kern, plain)
        first = samples if first is None else first
        check(np.array_equal(samples, first),
              f"{label}: samples differ from the dp walk's")
        walks[label] = {"launches": {k: launches[k] for k in kernels},
                        "walk_s": walk_s}
        print(f"tp {label}: session walk N={n} M={sites} in {walk_s:.3f} s; "
              f"launches {walks[label]['launches']}; kernel == plain "
              f"({n * sites} draws), env max abs diff {env_err:.3e}, "
              f"log_scale max abs diff {ls_err:.3e}", flush=True)
    _phase("tp", t0)
    return walks


def _kernel_numbers(name, kernel, plain, library, moved, flops, reps=5):
    """Kernel vs plain on the same inputs; times (CUDA events) and bound."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        scale = max(1.0, w.abs().max().item())
        check(torch.allclose(g / scale, w / scale, **TOL[w.dtype]),
              f"{name}: kernel and plain differ (max abs "
              f"{(g - w).abs().max().item():.3e})")
        err = max(err, (g - w).abs().max().item())
    del got, want
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP64_FLOPS * 1e3
    out = {"max_abs_err": err, "ms": time_ms(kernel, reps),
           "plain_ms": time_ms(plain, reps),
           "library_ms": time_ms(library, reps),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    print(f"{name}: ms={out['ms']:.3f} plain_ms={out['plain_ms']:.3f} "
          f"library_ms={out['library_ms']:.3f} bound_ms={out['bound_ms']:.3f}"
          f" ({out['bound_by']}: {moved / 1e9:.3f} GB, {flops / 1e12:.4f} "
          f"TFLOP) max_abs_err={err:.3e}", flush=True)
    return out


def phase_tp_kernels(device, mps, env, walks) -> list:
    """The three TP kernels at the bond-shard shapes of p₂ = 4 (N = 1024),
    on the chain's site 0 and the linear walk's final env."""
    from repro_torch.kernels import collapse_select as CS
    from repro_torch.kernels import contract_measure as CM
    from repro_torch.kernels import site_step as K

    t0 = time.perf_counter()
    n, shard = env.shape[0], CHI // TP_SHARDS
    gamma, lam = mps.gammas[0], mps.lambdas[0]
    env_s = env[:, :shard].contiguous()             # (N, χ/p₂)
    g_left = gamma[:shard]                           # (χ/p₂, χ, d)
    g_right = gamma[:, :shard].contiguous()          # (χ, χ/p₂, d)
    lam_s = lam[:shard].contiguous()
    w8 = 8                                           # bytes per fp64 word

    cm = []
    for e, g, l_ in ((env_s, g_left, lam), (env, g_right, lam_s)):
        (L, R, d) = g.shape
        g2 = g.reshape(L, R * d)
        moved = (n * L + L * R * d + R + n * R * d + n * d) * w8
        flops = 2 * n * L * R * d + 2 * n * R * d
        nums = _kernel_numbers(
            f"contract_measure {L}→{R}", lambda: CM.contract_measure(e, g, l_),
            lambda: CM.contract_measure_plain(e, g, l_),
            lambda: torch.matmul(e, g2), moved, flops)
        cm.append(dict(nums, shape={"n": n, "L": L, "R": R, "d": d}))
    tp_single = walks["tp_single"]["launches"]["contract_measure"]
    entries = [dict(cm[0], name="contract_measure", route="cuda",
                    source="src/repro_torch/kernels/csrc/site_step.cu",
                    replaces="src/repro/kernels/contract_measure.py:92",
                    launches=tp_single,
                    launches_tp_double=walks["tp_double"]["launches"][
                        "contract_measure"],
                    other_shapes=cm[1:])]

    w = CS.measure_weights(g_left.to(torch.float32), lam.to(torch.float32)
                           ).to(torch.float64)      # as the walk builds W
    nums = _kernel_numbers(
        f"measure_probs {shard}", lambda: K.measure_probs(env_s, w),
        lambda: K.measure_first_plain(env_s, w), lambda: env_s @ w,
        (n * shard + shard * D + n * D) * w8, 2 * n * shard * D)
    mf = walks["tp_single+measure_first"]["launches"]
    entries.append(dict(nums, name="measure_probs", route="cuda",
                        source="src/repro_torch/kernels/csrc/site_step.cu",
                        replaces="src/repro/kernels/site_step.py:379",
                        launches=mf["measure_probs"],
                        shape={"n": n, "L": shard, "d": D}))

    gen = torch.Generator(device=device).manual_seed(5)
    samples = torch.randint(0, D, (n,), generator=gen, device=device)
    present = int(torch.unique(samples).numel())
    g2 = g_left.reshape(shard, CHI * D)
    nums = _kernel_numbers(
        f"collapse_select {shard}→{CHI}",
        lambda: CS.collapse_select(env_s, g_left, samples),
        lambda: CS.collapse_select_plain(env_s, g_left, samples),
        lambda: torch.matmul(env_s, g2),
        (n * shard + shard * CHI * present + n + n * CHI) * w8,
        2 * n * shard * CHI)
    entries.append(dict(nums, name="collapse_select", route="cuda",
                        source="src/repro_torch/kernels/csrc/site_step.cu",
                        replaces="src/repro/kernels/collapse_select.py:83",
                        launches=mf["collapse_select"],
                        shape={"n": n, "L": shard, "R": CHI, "d": D,
                               "outcomes_present": present}))
    del env_s, g_right, w, g2
    torch.cuda.empty_cache()
    _phase("tp kernels", t0)
    return entries


def phase_tp_born(mesh, mps) -> None:
    """A Born tp_double walk on the mesh (its contraction stays plain
    PyTorch by design) against the Born dp walk, which runs the kernel."""
    from repro_torch import api
    from repro_torch.core import prng

    t0 = time.perf_counter()
    n, key = BORN_N, prng.key(13)
    tw = time.perf_counter()
    cfg = api.SamplerConfig(kernels="cuda", scheme="tp_double")
    with api.SamplingSession(mps, cfg, mesh=mesh) as session:
        samples = session.sample(n, key)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - tw
    td = _segment(mesh, mps, n, key, "tp_double", False, "cuda")
    dp = _segment(mesh, mps, n, key, "dp", False, "cuda")
    torch.cuda.synchronize()
    check(np.array_equal(td[0].T.cpu().numpy(), samples),
          "born tp_double: session and segment walk differ")
    env_err, ls_err = _same_walk("born tp_double vs dp", td, dp)
    print(f"born tp_double: session walk N={n} M={mps.n_sites} in "
          f"{walk_s:.3f} s; == the dp walk ({n * mps.n_sites} draws), env "
          f"max abs diff {env_err:.3e}, log_scale max abs diff "
          f"{ls_err:.3e}", flush=True)
    _phase("tp born", t0)


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
    import torch.distributed as dist

    device = phase_device()
    sys.path.insert(0, str(SRC))
    phase_build()
    phase_small(device)
    mesh = phase_nccl(device)
    try:
        linear, mps, env = phase_full(device, "linear")
        walks = phase_tp(mesh, mps)
        tp_entries = phase_tp_kernels(device, mps, env, walks)
        del mps, env
        torch.cuda.empty_cache()
        born, mps, _ = phase_full(device, "born")
        phase_tp_born(mesh, mps)
        del mps
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    phase_cli()
    entries = [linear, born, *tp_entries]
    print("kernels:", json.dumps(entries))
    print(nvidia_smi())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
