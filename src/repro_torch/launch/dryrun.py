"""Dry run of the paper's own workload on the production meshes: the GBS
half of the JAX package's ``launch/dryrun.py`` (ROADMAP §1 row 19a).

For every (preset × scheme × mesh) cell, the port's multi-level sampler
(``core/parallel._multilevel_sample``) walks the whole chain once as rank 0
of a fake process group of 256 (16×16) or 512 (2×16×16) ranks
(``launch/mesh.make_production_mesh``), on fake tensors: no storage, so
nothing is allocated on the card or the host.  ``launch/costs.py`` counts
the rank's FLOPs, memory traffic, collectives and live bytes on the way,
and derives the roofline terms with the constants of one NVIDIA H100 80GB
HBM3 at 700 W.  The walk runs the plain cells (``kernels="torch"``), as the
JAX dry run off a TPU counts its XLA cells.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --gbs --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --gbs-opt  # Γ bf16,
      # bf16 wire, measure-first
  PYTHONPATH=src python -m repro_torch.launch.dryrun --gbs --device cpu

Results are cached as JSON under experiments/dryrun_torch/ (the JAX
package's file names and keys, less its two TPU fields); --force walks
again.  The LM cells (``--arch``, ``--all``, ``--shape``,
``--remat-block``) are ROADMAP §1 row 19b and raise until it is ported.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import gbs
from repro_torch.core import parallel as PP
from repro_torch.core import prng
from repro_torch.core import sampler as S
from repro_torch.core.mps import MPS
from repro_torch.device import resolve_device
from repro_torch.launch import costs as C
from repro_torch.launch.mesh import data_axis_names, make_production_mesh

OUT_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "experiments", "dryrun_torch")
PRESETS = ("b-m288", "m8176")
SCHEMES = ("dp", "tp_single", "tp_double")
LM_CELLS = ("the LM cells of the dry run are ROADMAP §1 row 19b, not "
            "ported yet")


def gbs_flops(preset: gbs.GBSPreset, scheme: str, optimized: bool,
              n_local: int, p2: int = 16) -> float:
    """A cell's per-device dot FLOPs in closed form: ``n_local`` samples a
    device, χ' = χ/p₂ its bond shard under TP.  dp: contract 2nχ²d and
    measure 2nχd a site; tp_single: the split-K contract 2nχ'χd and the
    partial measure 2nχd a site, or measure-first (``optimized``): W = Γ·Λ
    2χ'χd, probs 2nχ'd and the select-GEMM 2nχ'χd; tp_double, a pair: the
    odd site's 2nχ'χd + 2nχd, the even site's 2nχχ'd + 2nχ'd."""
    m, chi, d, n = preset.n_sites, preset.chi, preset.d, n_local
    c = chi // p2
    if scheme == "dp":
        return float(m * (2 * n * chi * chi * d + 2 * n * chi * d))
    if scheme == "tp_single" and optimized:
        return float(m * (2 * c * chi * d + 2 * n * c * d
                          + 2 * n * c * chi * d))
    if scheme == "tp_single":
        return float(m * (2 * n * c * chi * d + 2 * n * chi * d))
    return float(m // 2 * (2 * n * c * chi * d + 2 * n * chi * d
                           + 2 * n * chi * c * d + 2 * n * c * d))


def _count(mesh, preset: gbs.GBSPreset, n_sites: int, n_samples: int,
           pcfg: PP.ParallelConfig, gamma_dtype: torch.dtype) -> C.Cost:
    """One rank's walk of ``n_sites`` sites of ``preset``'s chain on fake
    tensors, counted."""
    scfg = S.SamplerConfig(compute_dtype=torch.bfloat16, kernels="torch")
    key = prng.key(0)
    with FakeTensorMode(), C.CostCounter() as counter:
        gammas = torch.empty((n_sites, preset.chi, preset.chi, preset.d),
                             dtype=gamma_dtype, device=mesh.device)
        lambdas = torch.empty((n_sites, preset.chi), dtype=torch.float32,
                              device=mesh.device)
        counter.arguments(gammas, lambdas)
        out = PP._multilevel_sample(mesh, MPS(gammas, lambdas, "linear"),
                                    n_samples, key, pcfg, scfg)
        counter.outputs(out)
    return counter.cost


def analyze_cell(cost: C.Cost, once: C.Cost, meta: dict) -> dict:
    """The JAX package's cell record from the counts of the whole walk
    (``cost``) and of one loop body (``once``: the walk of one site, of one
    pair for tp_double, what XLA's ``cost_analysis()`` counts of a scan)."""
    rf = C.roofline(cost, meta["n_chips"], meta["model_flops"])
    tail = []
    for c in reversed(cost.collectives):
        if c.kind != "all-gather":
            break
        tail.append(c)
    out = dict(meta)
    out.update({
        "bytes_per_device": cost.bytes_per_device(),
        "xla_cost_analysis": {"flops_once": once.flops,
                              "bytes_once": once.memory_bytes},
        "hlo": {
            "flops_per_device": cost.flops,
            "memory_bytes_per_device": cost.memory_bytes,
            "collective_wire_bytes_per_device": cost.collective_wire_bytes,
            "per_collective": cost.per_collective,
            "n_collectives": cost.n_collectives,
            "wire_bytes_by_link": cost.wire_bytes_by_link,
            # every rank returns the full result: the all-gathers that end
            # the segment, apart from the chain's own collectives
            "end_gathers": {"n": len(tail),
                            "wire_bytes": sum(c.wire_bytes for c in tail)},
        },
        "roofline": rf.table_row(),
        "constants": {"device": C.DEVICE_NAME,
                      "power_limit_w": C.POWER_LIMIT_W},
    })
    return out


def run_gbs_cell(preset_name: str, scheme: str, mesh_kind: str,
                 force: bool = False, out_root: str = OUT_ROOT,
                 micro_batch: int = 4096, optimized: bool = False,
                 device=None) -> dict:
    """Walk one cell, write its JSON and return it (the cached JSON unless
    ``force``).  ``device`` is where the fake tensors claim to live: the
    card unless ``"cpu"``."""
    multi = mesh_kind == "multi"
    mesh_name = "2x16x16" if multi else "16x16"
    os.makedirs(out_root, exist_ok=True)
    suffix = "_opt" if optimized else ""
    path = os.path.join(
        out_root,
        f"gbs-{preset_name}__{scheme}{suffix}__"
        f"{'multi' if multi else 'single'}.json")
    if not force and os.path.exists(path):
        with open(path) as f:
            return json.load(f)

    p = gbs.PRESETS[preset_name]
    try:
        mesh = make_production_mesh(multi_pod=multi, device=device)
        try:
            n_chips = dist.get_world_size()
            # pure DP has no χ split: every mesh axis is a data axis
            daxes = (mesh.axis_names if scheme == "dp"
                     else data_axis_names(mesh))
            p1 = 1
            for ax in daxes:
                p1 *= mesh.shape[ax]
            n_samples = micro_batch * p1
            # optimized: Γ stored as bf16, a bf16 collective wire and
            # measure-first (the JAX package's §Perf iterations tp-1/tp-2)
            pcfg = PP.ParallelConfig(
                scheme=scheme, data_axes=daxes,
                wire_dtype=torch.bfloat16 if optimized else None,
                measure_first=optimized)
            gdt = torch.bfloat16 if optimized else torch.float32
            t0 = time.time()
            cost = _count(mesh, p, p.n_sites, n_samples, pcfg, gdt)
            t1 = time.time()
            once = _count(mesh, p, 2 if scheme == "tp_double" else 1,
                          n_samples, pcfg, gdt)
        finally:
            dist.destroy_process_group()
        # MODEL_FLOPS: the chain GEMMs = 2·N·M·χ²·d (+measure, lower order)
        mf = 2.0 * n_samples * p.n_sites * p.chi * p.chi * p.d
        meta = {"arch": f"gbs-{preset_name}", "shape": scheme,
                "mesh": mesh_name, "n_chips": n_chips,
                "compile_s": round(t1 - t0, 1), "model_flops": mf,
                "n_samples": n_samples, "chi": p.chi, "n_sites": p.n_sites,
                "d": p.d}
        result = analyze_cell(cost, once, meta)
    except Exception as e:                                    # noqa: BLE001
        result = {"arch": f"gbs-{preset_name}", "shape": scheme,
                  "mesh": mesh_name, "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-2000:]}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, path)
    return result


def summarize(result: dict) -> str:
    if "skipped" in result:
        return (f"{result['arch']:22s} {result['shape']:12s} "
                f"{result['mesh']:8s} SKIP ({result['skipped'][:48]})")
    if "error" in result:
        return (f"{result['arch']:22s} {result['shape']:12s} "
                f"{result['mesh']:8s} FAIL {result['error'][:80]}")
    rf = result["roofline"]
    mem = result["bytes_per_device"]["peak_estimate"] / 1e9
    return (f"{result['arch']:22s} {result['shape']:12s} {result['mesh']:8s} "
            f"ok  mem/dev={mem:6.1f}GB  "
            f"tc={rf['t_compute_s']:.3e} tm={rf['t_memory_s']:.3e} "
            f"tx={rf['t_collective_s']:.3e} [{rf['bottleneck'][:4]}] "
            f"useful={rf['useful_ratio']:.2f} "
            f"compile={result['compile_s']:.0f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--gbs", action="store_true")
    ap.add_argument("--gbs-opt", action="store_true",
                    help="optimized GBS variants (Γ bf16, bf16 wire, "
                         "measure-first)")
    ap.add_argument("--preset", choices=PRESETS, action="append",
                    help="GBS presets to walk (default: all of them)")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat-block", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the fake tensors live (default: the card)")
    ap.add_argument("--out", default=OUT_ROOT)
    args = ap.parse_args(argv)
    if args.arch or args.all or args.shape or args.remat_block:
        raise ValueError(LM_CELLS)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    if cuda:
        # the first fake tensor on a CUDA device makes the card's context
        # with one real element (torch's fake_tensor.init_gpu_context, once
        # a device): reported apart, and the peak counted from after it
        with FakeTensorMode():
            torch.empty(0, device=dev)
        context = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    failed = 0
    if args.gbs or args.gbs_opt:
        for preset in args.preset or PRESETS:
            for scheme in SCHEMES:
                for mk in meshes:
                    r = run_gbs_cell(preset, scheme, mk, force=args.force,
                                     out_root=args.out,
                                     optimized=args.gbs_opt,
                                     device=args.device)
                    failed += "error" in r
                    print(summarize(r), flush=True)
        if cuda:
            print("peak device memory allocated: "
                  f"{torch.cuda.max_memory_allocated()} bytes (before the "
                  f"walks, torch's fake-tensor context: {context} bytes)",
                  flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
