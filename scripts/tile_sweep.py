#!/usr/bin/env python3
"""Tile sweep of the tensor-core kernels, on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100 and nvcc:

    python3 scripts/tile_sweep.py [--only flash dmma c128 collapse measure
                                         bf16 collapse_bf16 displacement]
                                  [--shipped KIND ...] [--parent DIR]

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(warps per block and 16-row query tiles per warp, by head dim, given as
``FASTMPS_FLASH_TILES``) and of ``site_step.cu`` (the block, k and warp
tiles, ring depth and blocks an SM must hold of its fp64 GEMM,
``FASTMPS_DMMA_TILE``, of the Born step's complex128 GEMM,
``FASTMPS_DMMA_C128_TILE``, and of the fp64 grouped collapse,
``FASTMPS_DMMA_COLLAPSE_TILE``; the wgmma bf16 GEMM's column tile and ring
depth, ``FASTMPS_WGMMA_TILE``): each variant
is a file in ``build/tile_sweep/`` that defines the macros and includes the
source, compiled with ``nvcc``, all at once; ``--only`` builds and times
some of them (``measure``: ``measure_probs`` as the source holds it, timed
by its kernel's device time, torch.profiler; ``collapse_bf16``:
collapse_select's bf16 entry as the source holds it; ``displacement``:
``displacement_expm.cu`` as the source holds it), ``--shipped`` only
the variant the sources hold of the kinds it names.  ``--parent DIR`` also
builds the sources of another checkout (an unpacked ``git archive`` of the
parent commit) and times it first and last in each sweep, parent,
variants, parent.  Every variant is held
against the plain PyTorch version (bf16 flash within
``flash_attention.rounding_bound``, the fp64 and complex128 GEMMs within
1e-12 of the largest |temp| or |env'|, the linear step's samples equal),
then timed (CUDA events, median) at the shapes of ``chip_smoke.py``: flash
at granite-3-2b's prefill and its variants (kimi-k2's at Dh = 112 among
them), contract_measure at the p₂ = 4
shard shapes of χ = 10⁴, the Born site step at N = 512, χ = 10⁴, d = 4,
the fp64 linear site step at N = 1024, χ = 10⁴, d = 4 and collapse_select
at N = 1024, 2500 → 10⁴, d = 4 and, at χ = 10⁴, on fixed sizes of its
outcome groups (with the device time of each kernel of a call,
torch.profiler), measure_probs at N = 1024, L = 2500, d = 4, and (bf16)
the bf16 entries of contract_measure at the shard shapes and of the
linear site step at χ = 10⁴ in both bf16 tiers, each within its rounding
bound, beside ``torch.matmul`` of the bf16 operands and ``Γ.to(bf16)``
(the planes pass's bytes), (collapse_bf16) collapse_select's bf16 entry
at 2500 → 10⁴ in both tiers, on random outcomes and on groups of 1000, 12,
8 and 4 rows, and (displacement) displacement_expm at B = 2²⁰, d = 4 and
16, fp64 and fp32: its planes entry and the main path
(``ops.displacement_matrices``: the complex entry here, the parent's as
its wrapper ran it: the coefficient table built, μ's parts copied, the
planes entry, ``torch.complex``), each within ``rounding_bound`` of the
plain version, by CUDA events and by device time, then the planes entry
on μ's whose sums reach below the smallest normal number (its share of
the bound and the elements beyond it, reported, not held).  Prints each
variant's registers and spill bytes, the card's name and power limit first
and last.  The variant the sources hold is the first of each list.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import collapse_select as CS  # noqa: E402
from repro_torch.core.displacement import _tri_factor_log_coeffs  # noqa: E402
from repro_torch.kernels import contract_measure as CM  # noqa: E402
from repro_torch.kernels import displacement_expm as DE  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import site_step as K  # noqa: E402

# flash: warps and query tiles per warp for Dh = 64, then for Dh = 128,
# then for Dh = 112 (whose 14 chunks a row need a block of 128 threads or
# fewer)
FLASH = [(4, 2, 8, 1, 4, 1), (4, 1, 4, 1, 4, 2), (8, 2, 4, 1, 2, 2)]
# contract: BM, BN, BK, STAGES, WM, WN, MINB (blocks an SM must hold)
CONTRACT = [(128, 64, 16, 3, 32, 32, 2), (128, 64, 16, 3, 32, 32, 1),
            (64, 64, 16, 3, 32, 32, 1), (128, 128, 16, 3, 32, 64, 1),
            (128, 64, 32, 2, 32, 32, 1)]
# the complex128 GEMM, the same fields
C128 = [(64, 64, 16, 3, 32, 16, 1), (64, 64, 8, 4, 32, 16, 1),
        (64, 32, 8, 4, 32, 16, 1), (128, 32, 8, 4, 32, 16, 1),
        (128, 64, 8, 4, 32, 32, 1), (128, 64, 16, 3, 32, 32, 1),
        (64, 128, 8, 4, 32, 32, 1)]
# the fp64 grouped collapse, the same fields
COLLAPSE = [(128, 64, 16, 3, 32, 32, 2), (128, 64, 16, 3, 32, 32, 1),
            (256, 64, 16, 3, 32, 32, 1), (128, 128, 16, 3, 64, 32, 1),
            (64, 128, 16, 3, 32, 64, 2)]
# the wgmma bf16 GEMM of kernels 3 and 1: BN, STAGES
BF16 = [(256, 3), (256, 4), (256, 2), (128, 4)]
FLASH_SHAPES = [c for c in C.FLASH_CASES if c[5] == torch.bfloat16]
CONTRACT_SHAPES = [(1024, 2500, 10_000, 4), (1024, 10_000, 2500, 4)]
BORN_SHAPE = (C.BORN_N, C.CHI, C.CHI, C.D)
MEASURE_SHAPE = (C.LINEAR_N, C.CHI // C.TP_SHARDS, C.D)
LINEAR_SHAPE = (C.LINEAR_N, C.CHI, C.CHI, C.D)
# outcome group sizes for the collapse at LINEAR_SHAPE: balanced and random
# draws, chip_smoke.py's walk's draws at its site 0, and skewed draws
GROUPS = [(256, 256, 256, 256), (252, 266, 256, 250), (268, 244, 262, 250),
          (636, 131, 137, 120), (900, 100, 20, 4), (1000, 12, 8, 4)]
SELECT_SHAPE = (C.LINEAR_N, C.CHI // C.TP_SHARDS, C.CHI, C.D)
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def build(variants: dict) -> dict:
    """name -> (source name, {macro: value}, csrc directory): compile all at
    once, load with ctypes (a parent checkout's entries with its own
    argument types)."""
    out_dir = ROOT / "build" / "tile_sweep"
    procs = {}
    for i, (name, (source, defines, csrc)) in enumerate(variants.items()):
        d = out_dir / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text("".join(f"#define {k} {v}\n"
                                        for k, v in defines.items())
                                + f'#include "{csrc / source}.cu"\n')
        procs[name] = (source, d, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "k.so"),
             str(d / "k.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (source, d, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        regs = {k: v for k, v in _build.ptxas_kernels(log).items()
                if "tc_kernel" in k or "f64_kernel" in k or "wgmma" in k
                or "c128_kernel" in k or "measure_probs_kernel<4" in k
                or "planes" in k or "displacement" in k}
        print(f"{name}: ptxas {regs}", flush=True)
        lib = ctypes.CDLL(str(d / "k.so"))
        csrc = variants[name][2]
        signatures = (_build.SIGNATURES if csrc == CSRC
                      else _signatures(csrc.parent / "_build.py"))
        for fn, argtypes in signatures[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _signatures(path: Path) -> dict:
    """``SIGNATURES`` of another checkout's ``_build.py``."""
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES


def call(lib, entry, tensors, ints) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, entry)(*(ctypes.c_void_p(None if t is None
                                                else t.data_ptr())
                                for t in tensors), *ints,
                              ctypes.c_void_p(stream))
    C.check(err == 0, f"{entry}: cudaError {err}")


def sweep_flash(libs: list, device) -> None:
    gen = torch.Generator(device=device).manual_seed(23)
    for b, s, h, kvh, dh, dt, causal in FLASH_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(dt)
                   for shape in ((b, s, h, dh), (b, s, kvh, dh),
                                 (b, s, kvh, dh)))
        want = FA.flash_attention_plain(q, k, v, causal)
        bound = FA.rounding_bound(q, k, v, causal)
        flops = 4 * b * h * s * s * dh // (2 if causal else 1)
        row = []
        for name, lib in libs:
            out = torch.empty_like(q)

            def run():
                call(lib, "fastmps_flash_attention_bf16", (q, k, v, out),
                     (b, s, s, h, kvh, dh, int(causal)))
            run()
            torch.cuda.synchronize()
            share = ((out.float() - want.float()).abs() / bound).max().item()
            C.check(share <= 1.0, f"{name}: beyond the rounding bound")
            ms = C.time_ms(run, 10)
            row.append(f"{name}: {ms:.3f} ms ({flops / ms / 1e9:.0f} TFLOP/s,"
                       f" {share:.2f} of the rounding bound)")
        print(f"flash B={b} S={s} H={h} KVH={kvh} Dh={dh} "
              f"{'causal' if causal else 'full'}: " + " | ".join(row),
              flush=True)
        del q, k, v, want, bound
        torch.cuda.empty_cache()


def sweep_contract(libs: list, device) -> None:
    for n, L, R, d in CONTRACT_SHAPES:
        gen = torch.Generator(device=device).manual_seed(L)
        env = torch.rand((n, L), generator=gen, device=device,
                         dtype=torch.float64)
        gamma = torch.rand((L, R, d), generator=gen, device=device,
                           dtype=torch.float64)
        lam = torch.rand(R, generator=gen, device=device,
                         dtype=torch.float64)
        want, _ = CM.contract_measure_plain(env, gamma, lam)
        flops = 2 * n * L * R * d
        row = []
        for name, lib in libs:
            temp = torch.empty((n, R, d), dtype=torch.float64, device=device)
            probs = torch.empty((n, d), dtype=torch.float64, device=device)

            def run():
                call(lib, "fastmps_contract_measure_f64",
                     (env, gamma, lam, temp, probs), (n, L, R, d))
            run()
            torch.cuda.synchronize()
            err = ((temp - want).abs().max() / want.abs().max()).item()
            C.check(err <= 1e-12, f"{name}: differs from plain ({err:.3e})")
            ms = C.time_ms(run, 5)
            row.append(f"{name}: {ms:.3f} ms ({flops / ms / 1e9:.1f} "
                       "TFLOP/s)")
        lib_ms = C.time_ms(lambda: torch.matmul(env, gamma.reshape(L, R * d)),
                           5)
        print(f"contract_measure {L}→{R}: library {lib_ms:.3f} ms | "
              + " | ".join(row), flush=True)
        del env, gamma, lam, want
        torch.cuda.empty_cache()


def sweep_c128(libs: list, device) -> None:
    """The Born site step's entry at N = 512, χ = 10⁴, d = 4 (complex128):
    its temp (the GEMM's output) against ``torch.matmul``, then its time,
    beside the library's."""
    n, L, R, d = BORN_SHAPE
    gen = torch.Generator(device=device).manual_seed(L)
    env = torch.randn((n, L), generator=gen, device=device,
                      dtype=torch.complex128)
    gamma = torch.randn((L, R, d), generator=gen, device=device,
                        dtype=torch.complex128)
    lam = torch.rand(R, generator=gen, device=device, dtype=torch.float64)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    g2 = gamma.reshape(L, R * d)
    want = torch.matmul(env, g2).reshape(n, R, d)
    flops = 8 * n * L * R * d
    outs = (torch.empty((n, R), dtype=torch.complex128, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.float64, device=device),
            torch.empty((n, R, d), dtype=torch.complex128, device=device))
    row = []
    for name, lib in libs:
        def run():
            call(lib, "fastmps_site_step_born_c128", (env, gamma, lam, u,
                                                      *outs), (n, L, R, d, 1))
        run()
        torch.cuda.synchronize()
        err = ((outs[3] - want).abs().max() / want.abs().max()).item()
        C.check(err <= 1e-12, f"{name}: differs from plain ({err:.3e})")
        ms = C.time_ms(run, 3)
        row.append(f"{name}: {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
    lib_ms = C.time_ms(lambda: torch.matmul(env, g2), 3)
    print(f"site_step_born c128 N={n} χ={L} d={d}: library {lib_ms:.3f} ms "
          f"({flops / lib_ms / 1e9:.1f} TFLOP/s) | " + " | ".join(row),
          flush=True)
    del env, gamma, g2, want, outs
    torch.cuda.empty_cache()


def _parts(parts: dict, flops: float) -> str:
    """Device ms of each kernel of a call, and the collapse kernel's rate."""
    gemm = sum(ms * c for k, (ms, c) in parts.items()
               if k.startswith("collapse"))
    return (f"collapse {flops / gemm / 1e9:.1f} TFLOP/s; parts "
            + ", ".join(f"{k} {ms:.3f}" for k, (ms, _) in parts.items()))


def _sweep_entry(libs, entry, args, ints, held, flops) -> str:
    """One C entry of each variant on the same operands: held to the plain
    version (``held(name)`` after the call), then its time (CUDA events)
    and the device ms of each of its kernels (torch.profiler)."""
    row = []
    for name, lib in libs:
        def run():
            call(lib, entry, args, ints)
        run()
        torch.cuda.synchronize()
        held(name)
        ms = C.time_ms(run, 5)
        row.append(f"{name}: {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
                   + _parts(C.device_breakdown(run), flops))
    return " | ".join(row)


def sweep_collapse(libs: list, device) -> None:
    """The fp64 grouped collapse in its two entries: the linear site step
    at N = 1024, χ = 10⁴, d = 4 (against ``site_step_linear_plain``: samples
    equal, env' within 1e-12 of its largest |env'|) and collapse_select at
    2500 → 10⁴ (against ``collapse_select_plain``, 1e-12 of the largest
    |env'|); rates are of the collapse GEMM's 2·N·L·R flops."""
    gen = torch.Generator(device=device).manual_seed(C.CHI)
    f64 = dict(generator=gen, device=device, dtype=torch.float64)
    for label, (n, L, R, d) in (("site_step_linear", LINEAR_SHAPE),
                                ("collapse_select", SELECT_SHAPE)):
        env, gamma = torch.rand((n, L), **f64), torch.rand((L, R, d), **f64)
        out = torch.empty((n, R), dtype=torch.float64, device=device)
        perm = torch.empty(n, dtype=torch.int32, device=device)
        meta = torch.empty(3 * d + 1, dtype=torch.int32, device=device)
        if label == "site_step_linear":
            lam, u = torch.rand(R, **f64), torch.rand(n, **f64)
            want, drawn, _ = K.site_step_linear_plain(env, gamma, lam, u)
            samples = torch.empty(n, dtype=torch.int32, device=device)
            args = (env, gamma, lam, u, out, samples,
                    torch.empty(n, dtype=torch.float64, device=device),
                    torch.empty((L, d), dtype=torch.float64, device=device),
                    perm, meta)
            ints = (n, L, R, d, 1)
        else:
            samples = torch.randint(0, d, (n,), generator=gen, device=device,
                                    dtype=torch.int32)
            want, drawn = CS.collapse_select_plain(env, gamma, samples), None
            args, ints = (env, gamma, samples, out, perm, meta), (n, L, R, d)

        def held(name):
            C.check(drawn is None or torch.equal(samples.long(), drawn),
                    f"{name}: samples differ from plain")
            err = ((out - want).abs().max() / want.abs().max()).item()
            C.check(err <= 1e-12, f"{name}: env' differs from plain "
                    f"({err:.3e})")
        row = _sweep_entry(libs, f"fastmps_{label}_f64", args, ints, held,
                           2 * n * L * R)
        lib_ms = C.time_ms(lambda: torch.matmul(env, gamma.reshape(L, R * d)),
                           5)
        print(f"{label} f64 N={n} {L}→{R} d={d}: library (env @ Γ, d × the "
              f"collapse's flops) {lib_ms:.3f} ms | {row}", flush=True)
        del env, gamma, out, want, args
        torch.cuda.empty_cache()

    # the collapse's time by the sizes of its outcome groups (row tiles)
    n, L, R, d = LINEAR_SHAPE
    env, gamma = torch.rand((n, L), **f64), torch.rand((L, R, d), **f64)
    out = torch.empty((n, R), dtype=torch.float64, device=device)
    for sizes in GROUPS:
        samples = torch.from_numpy(np.random.default_rng(0).permutation(
            np.repeat(np.arange(d), sizes))).to(device, torch.int32)
        want = CS.collapse_select_plain(env, gamma, samples)

        def held(name):
            err = ((out - want).abs().max() / want.abs().max()).item()
            C.check(err <= 1e-12, f"{name}: env' differs from plain "
                    f"({err:.3e})")
        row = _sweep_entry(libs, "fastmps_collapse_select_f64",
                           (env, gamma, samples, out,
                            torch.empty(n, dtype=torch.int32, device=device),
                            torch.empty(3 * d + 1, dtype=torch.int32,
                                        device=device)),
                           (n, L, R, d), held, 2 * n * L * R)
        print(f"collapse_select groups {list(sizes)} N={n} {L}→{R}: {row}",
              flush=True)
        del want
    del env, gamma, out
    torch.cuda.empty_cache()


def sweep_measure(libs: list, device) -> None:
    """measure_probs at the p₂ = 4 shard shape (fp64, and bf16 inputs on
    fp64 operands) against the plain version, then each kernel's device
    time (torch.profiler, one kernel a call) beside ``env @ W``'s."""
    n, L, d = MEASURE_SHAPE
    gen = torch.Generator(device=device).manual_seed(L)
    env = torch.rand((n, L), generator=gen, device=device,
                     dtype=torch.float64)
    w = torch.rand((L, d), generator=gen, device=device, dtype=torch.float64)
    moved = (n * L + L * d + n * d) * 8
    for entry, cdt, dt in (("fastmps_measure_probs_f64", None, torch.float64),
                           ("fastmps_measure_probs_bf16_f64", torch.bfloat16,
                            torch.float32)):
        want = K.measure_first_plain(env, w, cdt)
        row = []
        for name, lib in libs:
            out = torch.empty((n, d), dtype=dt, device=device)

            def run():
                call(lib, entry, (env, w, out), (n, L, d))
            run()
            torch.cuda.synchronize()
            bound = (K.bf16_gemm_bound(env, w) if cdt else
                     1e-12 * want.abs().max())
            C.check(bool(((out.double() - want.double()).abs() <= bound)
                         .all()), f"{name}: {entry} differs from plain")
            ms = C.device_time_ms(run, 20, 1)
            row.append(f"{name}: {ms:.4f} ms ({moved / ms / 1e6:.1f} GB/s)")
        lib_ms = C.device_time_ms(lambda: env @ w, 20)
        print(f"{entry} N={n} L={L} d={d}: library (env @ W, fp64) "
              f"{lib_ms:.4f} ms | " + " | ".join(row), flush=True)
    del env, w
    torch.cuda.empty_cache()


def _bf16_run(libs, entry, args, extra, ints, held, flops):
    """One bf16 entry of each variant (``extra(name)``: its scratch, a
    parent's none): held to the plain version, then its time and the device
    ms of its GEMM and of its other kernels."""
    row = []
    for name, lib in libs:
        full = (*args, *extra(name))

        def run():
            call(lib, entry, full, ints)
        run()
        torch.cuda.synchronize()
        note = held(name)
        ms = C.time_ms(run, 10)
        for _ in range(3):    # the profiler leaves a launch out now and then
            parts = C.device_breakdown(run)
            gemm = sum(t * c for k, (t, c) in parts.items()
                       if k.startswith(("wgmma", "tc_")))
            if gemm > 0:
                break
        rate = f"{flops / gemm / 1e9:.0f} TFLOP/s" if gemm > 0 else \
            "not listed by the profiler"
        row.append(f"{name}: {ms:.3f} ms{note}, GEMM {gemm:.3f} ms "
                   f"({rate}); "
                   + ", ".join(f"{C.kernel_name(k).split('<')[0]} {t:.3f}"
                               for k, (t, _) in parts.items()))
    return " | ".join(row)


def sweep_bf16(libs: list, device) -> None:
    """The bf16 entries in both tiers (mxu_bf16: fp32 env and Γ; store_bf16:
    Γ bf16), N = 1024, d = 4: contract_measure at the p₂ = 4 shard shapes
    (temp within ``bf16_gemm_bound`` of the plain version), the linear site
    step at χ = 10⁴ (env' of the rows drawn alike within the bound, draws
    that differ counted); ``torch.matmul`` of the bf16 operands as the
    library.  Rates are of each GEMM's flops."""
    bf, f32 = torch.bfloat16, torch.float32
    n, d = C.LINEAR_N, C.D
    gen = torch.Generator(device=device).manual_seed(19)
    rand = dict(generator=gen, device=device, dtype=f32)
    tiers = {"mxu_bf16": "f32", "store_bf16": "bf16"}
    for L, R in ((C.CHI // C.TP_SHARDS, C.CHI), (C.CHI, C.CHI // C.TP_SHARDS)):
        env, g32 = torch.rand((n, L), **rand), torch.rand((L, R, d), **rand)
        lam = torch.rand(R, **rand) + 0.5
        bound = K.bf16_gemm_bound(env, g32.reshape(L, R * d)).reshape(n, R, d)
        temp = torch.empty((n, R, d), dtype=f32, device=device)
        probs = torch.empty((n, d), dtype=f32, device=device)
        for tier, tg in tiers.items():
            gamma = g32 if tg == "f32" else g32.to(bf)
            want, _ = CM.contract_measure_plain(env, gamma, lam, bf)

            def held(name):
                share = ((temp.double() - want.double()).abs() / bound).max()
                C.check(share.item() <= 1.0, f"{name}: temp beyond the bound")
                return f" ({share.item():.3f} of the bound)"
            scratch = CM.gemm_scratch(env, gamma)
            row = _bf16_run(libs, f"fastmps_contract_measure_bf16_f32_{tg}",
                            (env, gamma, lam, temp, probs),
                            lambda name: () if name == "parent" else scratch,
                            (n, L, R, d), held, 2 * n * L * R * d)
            eb, gb = env.to(bf), gamma.reshape(L, R * d).to(bf)
            lib_ms = C.time_ms(lambda: torch.matmul(eb, gb), 10)
            print(f"contract_measure bf16 {tier} {L}→{R}: library "
                  f"{lib_ms:.3f} ms | {row}", flush=True)
            del want, eb, gb, scratch
        del env, g32, bound, temp, lam
        torch.cuda.empty_cache()

    L = R = C.CHI
    env, g32 = torch.rand((n, L), **rand), torch.rand((L, R, d), **rand)
    lam, u = torch.rand(R, **rand) + 0.5, torch.rand(n, **rand)
    out = torch.empty((n, R), dtype=f32, device=device)
    samples = torch.empty(n, dtype=torch.int32, device=device)
    dlog = torch.empty(n, dtype=f32, device=device)
    for tier, tg in tiers.items():
        gamma = g32 if tg == "f32" else g32.to(bf)
        want, drawn, _ = K.site_step_linear_plain(env, gamma, lam, u, "none",
                                                  bf)
        bound = torch.empty((n, R), dtype=torch.float64, device=device)
        for s in range(d):
            rows = (drawn == s).nonzero().flatten()
            bound[rows] = K.bf16_gemm_bound(env[rows], g32[:, :, s])
        mine = K.linear_scratch(n, L, R, d, f32, device, bf)
        theirs = K.linear_scratch(n, L, R, d, f32, device)

        def held(name):
            keep = samples.long() == drawn
            share = ((out[keep].double() - want[keep].double()).abs()
                     / bound[keep]).max().item()
            C.check(share <= 1.0, f"{name}: env' beyond the bound")
            return (f" ({share:.3f} of the bound, {int((~keep).sum())} draws"
                    " differ)")
        row = _bf16_run(libs, f"fastmps_site_step_linear_bf16_f32_{tg}",
                        (env, gamma, lam, u, out, samples, dlog),
                        lambda name: theirs if name == "parent" else mine,
                        (n, L, R, d, 0), held, 2 * n * L * R)
        groups = torch.bincount(drawn, minlength=d).tolist()
        cast_ms = C.time_ms(lambda: gamma.to(bf), 10)
        print(f"site_step_linear bf16 {tier} N={n} χ={L} d={d} (groups "
              f"{groups}; scaling none; Γ.to(bf16), the planes' bytes: "
              f"{cast_ms:.3f} ms) | {row}", flush=True)
        del want, bound, mine, theirs
        torch.cuda.empty_cache()
    del env, g32, out
    torch.cuda.empty_cache()


def sweep_collapse_bf16(libs: list, device) -> None:
    """collapse_select's bf16 entry at N = 1024, 2500 → 10⁴, d = 4 in both
    tiers, on random outcomes and on groups of 1000, 12, 8 and 4 rows,
    within ``bf16_gemm_bound`` of the plain version; a parent's entry takes
    no bf16 scratch.  Rates are of the collapse's 2·N·L·R flops."""
    bf, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device=device).manual_seed(29)
    rand = dict(generator=gen, device=device, dtype=f32)
    n, L, R, d = SELECT_SHAPE
    env, g32 = torch.rand((n, L), **rand), torch.rand((L, R, d), **rand)
    out = torch.empty((n, R), dtype=f32, device=device)
    scratch = (torch.empty(n, dtype=torch.int32, device=device),
               torch.empty(3 * d + 1, dtype=torch.int32, device=device))
    mine = (*scratch, *CS.bf16_scratch(n, L, R, d, device))
    draws = {"random": torch.randint(0, d, (n,), generator=gen,
                                     device=device, dtype=torch.int32),
             "groups [1000, 12, 8, 4]": torch.from_numpy(
                 np.random.default_rng(0).permutation(np.repeat(
                     np.arange(d), GROUPS[-1]))).to(device, torch.int32)}
    bound_all = K.bf16_gemm_bound(env, g32.reshape(L, R * d)).reshape(
        n, R, d)
    for tier, tg in (("mxu_bf16", "f32"), ("store_bf16", "bf16")):
        gamma = g32 if tg == "f32" else g32.to(bf)
        for label, picks in draws.items():
            want = CS.collapse_select_plain(env, gamma, picks, bf)
            bound = torch.take_along_dim(bound_all, picks.long()[:, None,
                                                                 None],
                                         dim=2)[:, :, 0]

            def held(name):
                share = ((out.double() - want.double()).abs() / bound).max()
                C.check(share.item() <= 1.0, f"{name}: env' beyond the bound")
                return f" ({share.item():.3f} of the bound)"
            row = _bf16_run(libs, f"fastmps_collapse_select_bf16_f32_{tg}",
                            (env, gamma, picks, out),
                            lambda name: scratch if name == "parent"
                            else mine, (n, L, R, d), held, 2 * n * L * R)
            print(f"collapse_select bf16 {tier} {L}→{R} {label}: {row}",
                  flush=True)
            del want, bound
    del env, g32, out, mine, bound_all
    torch.cuda.empty_cache()


def _disp_planes(name, lib, re, im, d, out_re, out_im) -> None:
    """A planes entry: a parent's with its d × d table, this one's with the
    coefficient table of its sums and c."""
    dt, dev = re.dtype, re.device
    tables = ((DE.coeff_table(d, dt, dev),) if name == "parent"
              else (DE.horner_table(dt, dev),
                    DE.coeff_table(DE.MAX_D, dt, dev)))
    call(lib, "fastmps_displacement_expm_"
         + ("f64" if dt == torch.float64 else "f32"),
         (re, im, *tables, out_re, out_im), (re.numel(), d))


# |μ| where a sample's least summed magnitude falls below the smallest
# normal number at d = 16: tiny (the corner) and large (e^{−|μ|²/2})
BELOW_NORMAL = {torch.float32: ((1e-3, 1e-2), (13.2, 14.2)),
                torch.float64: ((1e-22, 1e-19), (37.7, 38.5))}


def report_below_normal(libs: list, device) -> None:
    """2¹⁶ μ's in each range of ``BELOW_NORMAL`` (tiny |μ| log-uniform,
    large |μ| uniform), d = 2, 4 and 16: each variant's planes entry
    against the plain version, its largest finite share of
    ``rounding_bound`` and the elements beyond it.  Reported, not held:
    there both versions round in subnormal steps."""
    rng = np.random.default_rng(5)
    n = 2 ** 16
    variants = dict(libs)
    for dt, ((t0, t1), (l0, l1)) in BELOW_NORMAL.items():
        for label, r in (("tiny", np.exp(rng.uniform(np.log(t0), np.log(t1),
                                                     n))),
                         ("large", rng.uniform(l0, l1, n))):
            mu = torch.polar(torch.from_numpy(r), torch.from_numpy(
                rng.uniform(0, 2 * np.pi, n))).to(device)
            mre, mim = mu.real.to(dt).contiguous(), mu.imag.to(dt).contiguous()
            for d in (2, 4, 16):
                want = DE.displacement_expm_plain(mre, mim, d)
                bound = DE.rounding_bound(mre, mim, d)
                out_re = torch.empty((n, d, d), dtype=dt, device=device)
                out_im = torch.empty_like(out_re)
                row = []
                for name, lib in variants.items():
                    _disp_planes(name, lib, mre, mim, d, out_re, out_im)
                    torch.cuda.synchronize()
                    share, beyond = 0.0, 0
                    for g, w in ((out_re, want[0]), (out_im, want[1])):
                        diff = (g - w).abs().double()
                        beyond += int((diff > bound).sum())
                        ratio = (diff / bound)[bound > 0]
                        share = max(share, ratio.max().item()
                                    if ratio.numel() else 0.0)
                    row.append(f"{name}: {share:.4g} of the bound, "
                               f"{beyond} elements beyond")
                print(f"displacement below the smallest normal, {label} |μ| "
                      f"in [{r.min():.3g}, {r.max():.3g}], d={d} {dt}: "
                      + " | ".join(row), flush=True)
                del want, bound, out_re, out_im
            torch.cuda.empty_cache()


def sweep_displacement(libs: list, device) -> None:
    """displacement_expm at B = 2²⁰ μ's (|μ| ≤ 1.5), d = 4 and 16, fp64 and
    fp32: the planes entry (a parent's with its d × d table, this one's with
    the coefficient table of its sums and c) and the main path, each within
    ``rounding_bound`` of the plain version; CUDA events and device time
    (torch.profiler: every kernel of a call, PyTorch's among them).  The
    variants run in turns, forward then backward, each timed twice.  Then
    ``report_below_normal``."""
    b = C.DISP_BATCH
    gen = torch.Generator(device=device).manual_seed(17)
    r = 1.5 * torch.sqrt(torch.rand(b, generator=gen, device=device,
                                    dtype=torch.float64))
    phi = 2 * np.pi * torch.rand(b, generator=gen, device=device,
                                 dtype=torch.float64)
    mu64 = torch.polar(r, phi)
    for d in C.DISP_DS:
        for cd, tag in ((torch.complex128, "f64"), (torch.complex64, "f32")):
            mu = mu64.to(cd)
            mre, mim = mu.real.contiguous(), mu.imag.contiguous()
            dt = mre.dtype
            want = DE.displacement_expm_plain(mre, mim, d)
            bound = DE.rounding_bound(mre, mim, d)
            out_re = torch.empty((b, d, d), dtype=dt, device=device)
            out_im = torch.empty_like(out_re)
            out = torch.empty((b, d, d), dtype=cd, device=device)
            row = []
            for name, lib in libs + libs[::-1]:
                parent = name == "parent"

                def planes():
                    _disp_planes(name, lib, mre, mim, d, out_re, out_im)

                def main():
                    if parent:      # its wrapper: table, copies, join
                        table = _tri_factor_log_coeffs(
                            d, torch.float64, device)[1].to(dt)
                        re, im = mu.real.contiguous(), mu.imag.contiguous()
                        call(lib, f"fastmps_displacement_expm_{tag}",
                             (re, im, table, out_re, out_im), (b, d))
                        return torch.complex(out_re, out_im)
                    real = torch.view_as_real
                    call(lib, "fastmps_displacement_expm_"
                         + ("c128" if tag == "f64" else "c64"),
                         (real(mu), DE.horner_table(dt, device),
                          DE.coeff_table(DE.MAX_D, dt, device), real(out)),
                         (b, d))
                    return out
                planes()
                got = main()
                torch.cuda.synchronize()
                share = 0.0
                for g, w in ((out_re, want[0]), (out_im, want[1]),
                             (got.real, want[0]), (got.imag, want[1])):
                    share = max(share, ((g - w).abs().double() / bound)
                                .nan_to_num(0.0).max().item())
                C.check(share <= 1.0, f"{name}: beyond the rounding bound")
                del got
                parts = C.device_breakdown(main, reps=10)
                row.append(
                    f"{name}: planes {C.time_ms(planes, 10):.4f} ms "
                    f"(device {C.device_time_ms(planes, 10, 1):.4f}), main "
                    f"path {C.time_ms(main, 10):.4f} ms (device "
                    f"{sum(t * c for t, c in parts.values()):.4f}, "
                    f"{len(parts)} kernels), {share:.3f} of the bound")
            print(f"displacement B={b} d={d} {dt}: " + " | ".join(row),
                  flush=True)
            del want, bound, out_re, out_im, out, mu, mre, mim
            torch.cuda.empty_cache()
    del mu64, r, phi
    torch.cuda.empty_cache()
    report_below_normal(libs, device)


def main() -> int:
    kinds = ("flash", "dmma", "c128", "collapse", "measure", "bf16",
             "collapse_bf16", "displacement")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", nargs="+", choices=kinds, default=kinds)
    ap.add_argument("--shipped", nargs="+", choices=kinds, default=(),
                    help="time only the variant the sources hold of these")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout whose kernels are timed beside these")
    args = ap.parse_args()
    C.check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    print(C.nvidia_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    variants = {}
    def tiles(kind, found):
        return (found[:1] if kind in args.shipped else found) \
            if kind in args.only else ()

    for v in tiles("flash", FLASH):
        variants[f"flash 64:{v[0]}x{v[1]} 128:{v[2]}x{v[3]} "
                 f"112:{v[4]}x{v[5]}"] = (
            "flash_attention",
            {"FASTMPS_FLASH_TILES": ", ".join(map(str, v))}, CSRC)
    for kind, macro, found in (
            ("dmma", "FASTMPS_DMMA_TILE", CONTRACT),
            ("c128", "FASTMPS_DMMA_C128_TILE", C128),
            ("collapse", "FASTMPS_DMMA_COLLAPSE_TILE", COLLAPSE)):
        for v in tiles(kind, found):
            bm, bn, bk, st, wm, wn, mb = v
            variants[f"{kind} {bm}x{bn}x{bk} s{st} w{wm}x{wn} b{mb}"] = (
                "site_step", {macro: ", ".join(map(str, v))}, CSRC)
    for bn, st in tiles("bf16", BF16):
        variants[f"bf16 128x{bn} s{st}"] = (
            "site_step", {"FASTMPS_WGMMA_TILE": f"{bn}, {st}"}, CSRC)
    sweeps = (("flash", sweep_flash, "flash_attention"),
              ("dmma", sweep_contract, "site_step"),
              ("c128", sweep_c128, "site_step"),
              ("collapse", sweep_collapse, "site_step"),
              ("measure", sweep_measure, "site_step"),
              ("bf16", sweep_bf16, "site_step"),
              ("collapse_bf16", sweep_collapse_bf16, "site_step"),
              ("displacement", sweep_displacement, "displacement_expm"))
    source_of = {kind: source for kind, _, source in sweeps}
    for kind in ("measure", "collapse_bf16", "displacement"):
        if kind in args.only:
            variants[kind] = (source_of[kind], {}, CSRC)
    parents = {}
    if args.parent is not None:
        pcsrc = args.parent.resolve() / "src" / "repro_torch" / "kernels" \
            / "csrc"
        for source in {source_of[k] for k in args.only}:
            variants[f"parent {source}"] = (source, {}, pcsrc)
    libs = build(variants)
    for source in set(source_of.values()):
        if f"parent {source}" in libs:
            parents[source] = [("parent", libs.pop(f"parent {source}"))]
    for kind, sweep, source in sweeps:
        if kind in args.only:
            mine = [(k, v) for k, v in libs.items()
                    if k == kind or k.startswith(kind + " ")]
            par = parents.get(source, [])
            sweep(par + mine + par, device)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
