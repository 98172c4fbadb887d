"""GBS sampling CLI of the port: argument parsing → config → session.

Builds a synthetic GBS-like linear MPS from ``--seed`` (the JAX package's
chain for the same seed), walks it in ``--macro-batches`` idempotent macro
batches through :class:`repro_torch.api.SamplingSession`, and writes
``batch_XXXXX.npy`` (int8 outcomes) and ``stats.json`` under ``--out``.
Batches already on disk are skipped, so a killed run resumes where it
stopped; batch b's key is ``fold_in(key(seed + 1), b)``, the JAX package's
CLI schedule, and the default scheme is ``dp``, as there: the same flags
write the same batch files in both packages.

Usage (on the card; ``--device cpu`` runs the plain PyTorch path):
  PYTHONPATH=src python -m repro_torch.launch.sample --sites 8 --chi 256 \
      --d 4 --samples 4096 --macro-batches 2 --out OUT_DIR

Over P ranks (one per card; gloo ranks with ``--device cpu``), with p₂ of
them per tensor-parallel group:
  PYTHONPATH=src torchrun --nproc-per-node=P -m repro_torch.launch.sample \
      --scheme tp_single --model-parallel 2 ... --out OUT_DIR
Every rank walks its shard; rank 0 writes the files.

``--precision mxu_bf16`` walks the fp32 chain with bf16 GEMM inputs and
fp32 sums, as the JAX package's CLI does.

``--stream`` walks the chain from a bf16 :class:`GammaStore` (``--store``,
by default ``OUT_DIR/gamma_store``, written from the chain when empty,
with its digest manifest, so every read is verified) in segments of
``--segment-len`` sites (0: the planner's pick), checkpointing each macro
batch per segment under ``OUT_DIR/chain_ckpt``.  ``--dynamic-bond`` walks
the area-law χ profile bucketed to {χ/4, χ/2, χ} (§3.4.2), as the JAX
package's CLI does; both compose with every scheme.  ``--clamp
1=0,3=1`` forces those outcomes (conditional sampling, every scheme but
``baseline19``): the batches skip chain checkpoints (a clamped macro batch
is rerun whole) and the run prints the clamped branch's ``log_prob`` and
the estimate of P(clamp).  Flags of the JAX package's CLI that later
slices port (``--service*``, ``--runtime`` other than local) raise
``NotImplementedError`` naming the ROADMAP.md row that ports them.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.api.config import unported
from repro_torch.core import dynamic_bond as DB
from repro_torch.core import mps as M
from repro_torch.core import precision, prng
from repro_torch.data.gamma_store import MANIFEST_NAME, GammaStore
from repro_torch.kernels import dispatch, ops
from repro_torch.launch.mesh import init_distributed, local_device, make_mesh
from repro_torch.runtime.elastic import WorkQueue
from repro_torch.workloads.clamp import parse_clamp_arg


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", type=int, default=64)
    ap.add_argument("--chi", type=int, default=64)
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--macro-batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--precision", default="fp64",
                    choices=["fp64", "fp32", "mxu_bf16"])
    ap.add_argument("--kernels", default="auto",
                    choices=["auto", "cuda", "torch"],
                    help="site-step dispatch: the Hopper kernels, the plain "
                         "PyTorch cells, or auto (cuda on the card)")
    ap.add_argument("--micro-batch", type=int, default=0,
                    help="N₂ (0 = whole macro batch)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a GPU the default "
                         "raises")
    ap.add_argument("--scheme", default="dp",
                    choices=["auto", "seq", "dp", "tp_single", "tp_double",
                             "baseline19"])
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="p₂: ranks per tensor-parallel group")
    ap.add_argument("--stream", action="store_true",
                    help="segment-streamed engine (Γ from --store, §3.1)")
    ap.add_argument("--store", default=None,
                    help="GammaStore dir; built from the synthetic MPS if "
                         "empty (default OUT_DIR/gamma_store)")
    ap.add_argument("--segment-len", type=int, default=0,
                    help="sites per streamed segment (0 = the planner's)")
    ap.add_argument("--dynamic-bond", action="store_true",
                    help="area-law χ profile in buckets (§3.4.2)")
    ap.add_argument("--clamp", default=None,
                    help="conditional sampling: site=outcome,... forced")
    # the JAX package's CLI flags that later slices port
    ap.add_argument("--runtime", default="auto",
                    choices=["auto", "local", "multihost", "remote"])
    ap.add_argument("--service", action="store_true")
    ap.add_argument("--service-workers", type=int, default=None)
    ap.add_argument("--service-fleet", action="store_true")
    return ap


def _reject_unported(args) -> None:
    if args.runtime not in ("auto", "local"):
        raise unported(f"--runtime {args.runtime}", 10,
                       "service and cluster layers")
    if args.service or args.service_fleet or args.service_workers:
        raise unported("--service", 10, "service and cluster layers")


def main(argv=None) -> None:
    args = _parser().parse_args(argv)
    _reject_unported(args)
    device = local_device(args.device)
    if args.samples % args.macro_batches:
        raise ValueError(f"--samples {args.samples} must divide over "
                         f"--macro-batches {args.macro_batches}")
    per_batch = args.samples // args.macro_batches
    created = init_distributed(device)      # a caller's group stays theirs
    try:
        _run(args, make_mesh(args.model_parallel, device), per_batch)
    finally:
        if created:
            dist.destroy_process_group()


def _run(args, mesh, per_batch: int) -> None:
    device, lead = mesh.device, dist.get_rank() == 0
    print(f"rank {dist.get_rank()}/{dist.get_world_size()} mesh "
          f"{mesh.shape} scheme {args.scheme} device {device}")
    if lead:
        os.makedirs(args.out, exist_ok=True)

    # built in fp64 and cast, as the JAX package's CLI does
    dtype = precision.policy_dtypes(args.precision)[0]
    compute = torch.bfloat16 if args.precision == "mxu_bf16" else None

    def build_mps():
        return M.gbs_like_mps(prng.key(args.seed), args.sites, args.chi,
                              args.d, dtype=torch.float64,
                              device=device).to(dtype=dtype)

    if args.stream:        # streaming never holds the whole chain
        root = args.store or os.path.join(args.out, "gamma_store")
        source = GammaStore(root, compute_dtype=dtype)
        if source.n_sites == 0 and lead:
            print(f"writing Γ store ({args.sites} sites) to {root}")
            source.write_mps(build_mps())
            source.write_digest_manifest()
        dist.barrier()                       # rank 0 wrote it
        if source.n_sites == 0:
            source.close()
            source = GammaStore(root, compute_dtype=dtype)
        # with a digest manifest every site read is checked against it
        source.verify = os.path.exists(os.path.join(root, MANIFEST_NAME))
    else:
        source = build_mps()
    chi_profile = None
    if args.dynamic_bond:
        prof = DB.area_law_profile(args.sites, args.chi, n_photon=1.0)
        buck = DB.bucketize(prof, sorted({max(args.model_parallel,
                                              args.chi // 4),
                                          args.chi // 2, args.chi}))
        chi_profile = tuple(int(c) for c in buck)
        print("table1:", DB.table1_metrics(prof, args.chi))
    clamp = parse_clamp_arg(args.clamp) if args.clamp else None
    if clamp is not None:
        print(f"clamp: {clamp} (clamped walks skip chain checkpoints — "
              f"macro-batch idempotence is the restart story)")
    config = api.SamplerConfig(
        scheme=args.scheme, kernels=args.kernels, compute_dtype=compute,
        backend="streamed" if args.stream else "inmem",
        micro_batch=args.micro_batch or None, chi_profile=chi_profile,
        segment_len=args.segment_len or api.AUTO, clamp=clamp)

    # resume: macro batches already on disk are done (idempotent by id);
    # rank 0 looks, so every rank walks the same batches
    n1 = args.macro_batches
    done = [[b for b in range(n1) if os.path.exists(
        os.path.join(args.out, f"batch_{b:05d}.npy"))]]
    dist.broadcast_object_list(done, src=0)
    queue = WorkQueue(n1)
    for b in done[0]:
        queue.complete(b)
    print(f"pending macro batches: {queue.pending}")

    base = prng.key(args.seed + 1)
    t0 = time.perf_counter()
    with api.SamplingSession(source, config, device=device,
                             mesh=mesh) as session:
        plan = session.plan(per_batch)
        print("plan:", plan)
        print("why:", session.explain(per_batch))
        print(f"kernel dispatch: requested={args.kernels!r} → resolved "
              f"{plan.kernels!r} (device={device}; registered ops: "
              f"{dispatch.registered_ops()})")

        lp_blocks: dict[int, np.ndarray] = {}

        def save_batch(b: int, out: np.ndarray) -> None:
            if lead:
                np.save(os.path.join(args.out, f"batch_{b:05d}.npy"),
                        out.astype(np.int8))
            if clamp is not None:
                lp_blocks[b] = np.asarray(session.stats["log_prob"],
                                          dtype=np.float64)
            print(f"macro batch {b} done ({per_batch} samples)", flush=True)

        session.run_queue(queue, per_batch, base, worker="cli",
                          checkpoint_root=(None if clamp is not None else
                                           os.path.join(args.out,
                                                        "chain_ckpt")),
                          on_batch=save_batch)
        engine_stats = {k: v for k, v in session.stats.items()
                        if k != "log_prob"}
        if engine_stats:
            print("streaming stats:", engine_stats)
        if lp_blocks:
            # ln P(clamped outcomes | earlier sites) per sample: the mean
            # of exp estimates the clamp's probability
            lp = np.concatenate([lp_blocks[b] for b in sorted(lp_blocks)])
            w = np.exp(lp)
            print(f"clamp log_prob: n={lp.size} mean={lp.mean():.6f} "
                  f"min={lp.min():.6f} max={lp.max():.6f}  "
                  f"P(clamp) ≈ {w.mean():.6g}")
    if args.stream:
        source.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print("kernel launches:", json.dumps(ops.launch_counts()))
    if not lead:
        return

    allb = [np.load(os.path.join(args.out, f"batch_{b:05d}.npy"))
            for b in range(n1)]
    samples = np.concatenate(allb, axis=0)
    mean_photons = samples.mean(axis=0)
    stats = {"n_samples": int(samples.shape[0]), "sites": args.sites,
             "chi": args.chi, "device": str(device), "scheme": plan.scheme,
             "backend": plan.backend,
             "mesh": mesh.shape, "walltime_s": time.perf_counter() - t0,
             "mean_photon_min": float(mean_photons.min()),
             "mean_photon_max": float(mean_photons.max())}
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()
