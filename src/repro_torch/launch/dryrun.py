"""Dry run on the production meshes: the port's ``launch/dryrun.py``.

Every cell is walked once as rank 0 of a fake process group of 256
(16×16) or 512 (2×16×16) ranks (``launch/mesh.make_production_mesh``), on
fake tensors: no storage, so nothing is allocated on the card or the host.
``launch/costs.py`` counts the rank's FLOPs, memory traffic, collectives
and live bytes on the way, and derives the roofline terms with the
constants of one NVIDIA H100 80GB HBM3 at 700 W.

* The GBS cells (ROADMAP §1 row 19a): the multi-level sampler
  (``core/parallel._multilevel_sample``) walks the whole chain on the
  rank's own arguments (Γ whole under dp, its tiles under TP) and keeps
  its result sharded, as the JAX package's ``shard_map`` does, on the
  plain cells (``kernels="torch"``), as the JAX dry run off a TPU counts
  its XLA cells.
* The LM cells of every family (rows 19b, 21 and 22): the rank holds its
  tile of every weight, batch row and cache
  (and of the optimizer's state) under the sharding policy
  (``launch/steps.py``) and runs
  ``make_train_step`` (train_4k: forward, recompute and backward with
  their collectives, the weights and the state updated in place as the
  reference donates them; ``--remat-block k`` its sqrt-L block remat),
  ``make_prefill_step`` (prefill_32k) or ``make_serve_step`` (decode_32k,
  and long_500k: one token against a context of 524288, B = 1 replicated
  over the data axes) with the collectives of a sharded rank
  (``models.common.TPLayout``; the MoE layer expert parallel, MLA split
  over its heads, a Mamba2 layer on its heads, the hybrid's shared block
  as a dense layer, whisper's encoder and decoder and the VLM's cross
  layers as dense attention and MLPs, a cross-attention's K/V from the
  rank's rows of ``enc_out`` or the patches), attention on the
  reference's default ``_sdpa`` route (its ``USE_FLASH`` is off; a decode
  step's cross-attention through the flash dispatch's plain version, whose
  products are ``_sdpa``'s).  long_500k is skipped for the
  full-attention archs, as the reference skips it.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --gbs --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --gbs-opt  # Γ bf16,
      # bf16 wire, measure-first
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \
      --shape prefill_32k --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \
      --shape train_4k --remat-block 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
      deepseek-v3-671b --device cpu   # its prefill, decode and train cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-7b \
      --device cpu                    # and its long_500k cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch zamba2-7b \
      --shape decode_32k --shape long_500k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu

Results are cached as JSON under experiments/dryrun_torch/ (the JAX
package's file names and keys, less its two TPU fields); --force walks
again.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.configs import gbs
from repro_torch.core import parallel as PP
from repro_torch.core import prng
from repro_torch.core import sampler as S
from repro_torch.core.mps import MPS
from repro_torch.device import resolve_device
from repro_torch.launch import costs as C
from repro_torch.launch import steps
from repro_torch.launch.mesh import data_axis_names, make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.common import clear_mesh_axes, set_mesh_axes
from repro_torch.optim import optimizers

OUT_ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "experiments", "dryrun_torch")
PRESETS = ("b-m288", "m8176")
SCHEMES = ("dp", "tp_single", "tp_double")
LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


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
    tensors, counted: its arguments are the whole Γ under dp and its tiles
    under TP (the JAX package's ``in_specs``), its result its shard."""
    scfg = S.SamplerConfig(compute_dtype=torch.bfloat16, kernels="torch")
    key = prng.key(0)
    chi, d, dev = preset.chi, preset.d, mesh.device
    with FakeTensorMode(), C.CostCounter() as counter:
        lambdas = torch.empty((n_sites, chi), dtype=torch.float32,
                              device=dev)
        if pcfg.scheme == "dp":
            chain = MPS(torch.empty((n_sites, chi, chi, d),
                                    dtype=gamma_dtype, device=dev), lambdas)
            counter.arguments(chain.gammas, lambdas)
        else:
            c = chi // mesh.shape[pcfg.model_axis]
            rows = n_sites // 2 if pcfg.scheme == "tp_double" else n_sites
            right = None
            if pcfg.scheme == "tp_double":
                right = torch.empty((n_sites // 2, chi, c, d),
                                    dtype=gamma_dtype, device=dev)
            chain = PP.ChainTile(
                torch.empty((rows, c, chi, d), dtype=gamma_dtype,
                            device=dev), lambdas, "linear", pcfg.scheme,
                mesh.shape[pcfg.model_axis], 0, right)
            counter.arguments(chain.gammas, right, lambdas)
        out = PP._multilevel_sample(mesh, chain, n_samples, key, pcfg, scfg,
                                    sharded=True)
        counter.outputs(out)
    return counter.cost


def analyze_cell(cost: C.Cost, once: C.Cost, meta: dict,
                 end_gathers: bool = True) -> dict:
    """The JAX package's cell record from the counts of the whole walk
    (``cost``) and of one loop body (``once``: the walk of one site, of one
    pair for tp_double, of one layer for an LM cell: what XLA's
    ``cost_analysis()`` counts of a scan).  ``end_gathers`` (the GBS
    cells): the all-gathers that end the walk, counted apart."""
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
        },
        "roofline": rf.table_row(),
        "constants": {"device": C.DEVICE_NAME,
                      "power_limit_w": C.POWER_LIMIT_W},
    })
    if end_gathers:
        # a walk that gathered its result would end in these, apart from
        # the chain's own collectives (the sharded walk has none)
        out["hlo"]["end_gathers"] = {
            "n": len(tail), "wire_bytes": sum(c.wire_bytes for c in tail)}
    return out


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def model_flops_of(cfg: T.ModelConfig, shape: configs.ShapeSpec) -> float:
    """MODEL_FLOPS = 6·N·D (train) / 2·N·D (fwd-only), N = active params."""
    _, active = cfg.param_count()
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch       # one token a sequence


# the weights a step never reads, which ``jax.jit`` leaves out of the
# reference's arguments (``keep_unused=False``): whisper's decode step takes
# ``enc_out`` in its batch and reads no encoder weight
_UNREAD = {("encdec", "decode"): ("enc_layers/", "enc_pos", "enc_ln_f")}


def _read_weights(params: T.Transformer, cfg: T.ModelConfig,
                  kind: str) -> list:
    """The rank's weight tiles that a ``kind`` step reads."""
    unread = _UNREAD.get((cfg.family, kind), ())
    return [t for path, leaf in params.ref_leaves().items()
            if not path.startswith(unread) for t in leaf.tensors]


def _lm_step(mesh, cfg: T.ModelConfig, shape: configs.ShapeSpec) -> C.Cost:
    """One rank's step of the cell on fake tensors, counted: its tiles of
    the weights (guarded, FSDP above 8 GB of bf16 weights, as the
    reference's ``lower_cell`` decides), of the batch and of the caches or
    the optimizer's state (``optimizer_for``, as the reference's) are the
    arguments; the caches, or the weights and the state, are written in
    place (the reference donates them), so the outputs are the step's
    result (its metrics for train)."""
    fsdp = cfg.param_count()[0] * 2 > 8e9
    opt = optimizers.optimizer_for(cfg)
    with FakeTensorMode():
        whole, specs, extra = steps.abstract_state(
            cfg, opt, shape.kind, shape.global_batch, shape.seq_len,
            device=mesh.device)
        psh = steps.param_shardings(mesh, whole, specs, fsdp)
        params = steps.shard_params(whole, psh, mesh)
        batch = configs.input_specs(cfg, shape, device=mesh.device)
        batch = steps.shard_batch(batch, steps.batch_shardings(mesh, batch),
                                  mesh)
        state = opt_state = None
        if shape.kind == "decode":
            state = steps.shard_state(
                extra, steps.cache_shardings(mesh, cfg, extra.caches), mesh)
        elif shape.kind == "train":
            opt_state = steps.shard_opt_state(
                extra, steps.opt_state_shardings(mesh, extra, psh), mesh)
        del whole, extra
        with C.CostCounter() as counter:
            counter.arguments(_read_weights(params, cfg, shape.kind), batch)
            if opt_state is not None:
                counter.arguments(opt_state)
                _, _, out = steps.make_train_step(cfg, opt)(
                    params, opt_state, batch)
            elif state is None:
                out = steps.make_prefill_step(cfg, kernels="torch",
                                              flash=False)(params, batch)
            else:
                counter.arguments(state.caches, state.position)
                out, _ = steps.make_serve_step(cfg, kernels="torch")(
                    params, batch, state)
            counter.outputs(out)
    return counter.cost


def count_cell(arch: str, shape_name: str, multi_pod: bool,
               remat_block: int = 0, device=None):
    """The counterpart of the reference's ``lower_cell``: one LM cell
    walked as rank 0 of the fake group under the cost counter.  Returns
    ((the whole step's cost, one loop body's: a layer's, a block of
    ``remat_block`` layers'), meta), or (None, {"skipped": why}) for a
    cell the reference skips."""
    cfg = configs.get_config(arch)
    if remat_block:
        cfg = dataclasses.replace(cfg, remat_block=remat_block)
    shape = configs.SHAPES[shape_name]
    ok, why = configs.cell_supported(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    try:
        n_chips = dist.get_world_size()
        set_mesh_axes(data_axis_names(mesh), mesh=mesh)
        t0 = time.time()
        cost = _lm_step(mesh, cfg, shape)
        t1 = time.time()
        once = _lm_step(mesh, dataclasses.replace(
            cfg, n_layers=max(1, cfg.remat_block)), shape)
    finally:
        clear_mesh_axes()
        dist.destroy_process_group()
    return (cost, once), {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips, "compile_s": round(t1 - t0, 1),
        "model_flops": model_flops_of(cfg, shape)}


def run_cell(arch: str, shape_name: str, mesh_kind: str, force: bool = False,
             out_root: str = OUT_ROOT, remat_block: int = 0,
             device=None) -> dict:
    """Walk one LM cell, write its JSON (the reference's file name) and
    return it (the cached JSON unless ``force``)."""
    multi = mesh_kind == "multi"
    mesh_name = "2x16x16" if multi else "16x16"
    os.makedirs(out_root, exist_ok=True)
    rb = f"__rb{remat_block}" if remat_block else ""
    path = os.path.join(
        out_root,
        f"{arch}__{shape_name}{rb}__{'multi' if multi else 'single'}.json")
    if not force and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    try:
        costs, meta = count_cell(arch, shape_name, multi, remat_block,
                                 device)
        if costs is None:
            result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                      **meta}
        else:
            result = analyze_cell(*costs, meta, end_gathers=False)
    except Exception as e:                                    # noqa: BLE001
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-2000:]}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, path)
    return result


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
    ap.add_argument("--shape", action="append",
                    help="an LM cell's shape (again for more; default: all)")
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
    if args.arch and args.arch not in configs.ARCHS:
        raise ValueError(f"--arch {args.arch}: one of {configs.ARCHS}")
    for shape in args.shape or ():
        if shape not in LM_SHAPES:
            raise ValueError(f"--shape {shape}: one of {LM_SHAPES}")

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
    if args.all or args.arch:
        for arch in [args.arch] if args.arch else configs.ARCHS:
            for shape in args.shape or LM_SHAPES:
                for mk in meshes:
                    r = run_cell(arch, shape, mk, force=args.force,
                                 out_root=args.out,
                                 remat_block=args.remat_block,
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
