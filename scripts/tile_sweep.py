#!/usr/bin/env python3
"""Tile sweep of the two tensor-core kernels, on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA H100 and nvcc:

    python3 scripts/tile_sweep.py

Builds variants of ``src/repro_torch/kernels/csrc/flash_attention.cu``
(warps per block and 16-row query tiles per warp, by head dim, given as
``FASTMPS_FLASH_TILES``) and of ``site_step.cu`` (the fp64 GEMM's block, k
and warp tiles and its ring depth, given as ``FASTMPS_DMMA_TILE``): each
variant is a file in ``build/tile_sweep/`` that defines the macro and
includes the source, compiled with ``nvcc``, all at once.  Every variant is
held against the plain PyTorch version (bf16 flash within
``flash_attention.rounding_bound``, fp64 contract_measure within 1e-12 of the
largest |temp|), then timed (CUDA events, median) at the shapes of
``chip_smoke.py``: flash at granite-3-2b's prefill and its variants,
contract_measure at the p₂ = 4 shard shapes of χ = 10⁴.  Prints the card's
name and power limit first and last.  The variant the sources hold is the
first of each list.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import contract_measure as CM  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

# flash: warps and query tiles per warp for Dh = 64, then for Dh = 128
FLASH = [(4, 2, 8, 1), (4, 1, 4, 1), (8, 2, 4, 1)]
# contract: BM, BN, BK, STAGES, WM, WN
CONTRACT = [(128, 64, 16, 3, 32, 32), (64, 64, 16, 3, 32, 32),
            (128, 128, 16, 3, 32, 64), (128, 64, 32, 2, 32, 32)]
FLASH_SHAPES = [c for c in C.FLASH_CASES if c[5] == torch.bfloat16]
CONTRACT_SHAPES = [(1024, 2500, 10_000, 4), (1024, 10_000, 2500, 4)]


def build(variants: dict) -> dict:
    """name -> (source name, macro, value): compile all at once, load with
    ctypes."""
    out_dir = ROOT / "build" / "tile_sweep"
    procs = {}
    csrc = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
    for i, (name, (source, macro, value)) in enumerate(variants.items()):
        d = out_dir / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(f"#define {macro} {value}\n"
                                f'#include "{csrc / source}.cu"\n')
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
                if "tc_kernel" in k or "f64_kernel" in k}
        print(f"{name}: ptxas {regs}", flush=True)
        lib = ctypes.CDLL(str(d / "k.so"))
        for fn, argtypes in _build.SIGNATURES[source].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def call(lib, entry, tensors, ints) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, entry)(*(ctypes.c_void_p(t.data_ptr())
                                for t in tensors), *ints,
                              ctypes.c_void_p(stream))
    C.check(err == 0, f"{entry}: cudaError {err}")


def sweep_flash(libs: dict, device) -> None:
    gen = torch.Generator(device=device).manual_seed(23)
    for b, s, h, kvh, dh, dt, causal in FLASH_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device=device).to(dt)
                   for shape in ((b, s, h, dh), (b, s, kvh, dh),
                                 (b, s, kvh, dh)))
        want = FA.flash_attention_plain(q, k, v, causal)
        bound = FA.rounding_bound(q, k, v, causal)
        flops = 4 * b * h * s * s * dh // (2 if causal else 1)
        row = []
        for name, lib in libs.items():
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


def sweep_contract(libs: dict, device) -> None:
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
        for name, lib in libs.items():
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


def main() -> int:
    C.check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    print(C.nvidia_smi(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    variants = {}
    for v in FLASH:
        variants[f"flash 64:{v[0]}x{v[1]} 128:{v[2]}x{v[3]}"] = (
            "flash_attention", "FASTMPS_FLASH_TILES",
            ", ".join(map(str, v)))
    for v in CONTRACT:
        bm, bn, bk, st, wm, wn = v
        variants[f"dmma {bm}x{bn}x{bk} s{st} w{wm}x{wn}"] = (
            "site_step", "FASTMPS_DMMA_TILE", ", ".join(map(str, v)))
    libs = build(variants)
    sweep_flash({k: v for k, v in libs.items() if k.startswith("flash")},
                device)
    sweep_contract({k: v for k, v in libs.items() if k.startswith("dmma")},
                   device)
    print(C.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
