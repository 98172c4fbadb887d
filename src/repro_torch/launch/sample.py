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
batch per segment under ``OUT_DIR/chain_ckpt`` (rank r of a job of
several under ``OUT_DIR/chain_ckpt_rank<r>``: each rank checkpoints its
own walk).  ``--dynamic-bond`` walks
the area-law χ profile bucketed to {χ/4, χ/2, χ} (§3.4.2), as the JAX
package's CLI does; both compose with every scheme.  ``--clamp
1=0,3=1`` forces those outcomes (conditional sampling, every scheme but
``baseline19``): the batches skip chain checkpoints (a clamped macro batch
is rerun whole) and the run prints the clamped branch's ``log_prob`` and
the estimate of P(clamp).

``--service`` runs the whole run as one multi-batch job of a
:class:`~repro_torch.api.SamplingService` over ``--service-workers``
thread lanes (the same batch files: batch b's key is the same), printing a
progress line per batch; ``--service-fleet`` backs each lane with a
persistent worker process (``repro_torch.runtime.transport``) on the same
device.  ``--runtime remote`` dispatches each macro batch to a worker
process (``repro_torch.api.remote``); ``--runtime multihost`` needs a
``torch.distributed`` job of ≥ 2 ranks (``torchrun``) and ``--stream``:
rank 0 reads each segment and broadcasts it over a gloo group.  A fault of
the taxonomy (a rotted Γ site, a dead-lettered batch) exits with code 2
and a JSON fault record on stderr.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import api
from repro_torch.core import dynamic_bond as DB
from repro_torch.core import mps as M
from repro_torch.core import precision, prng
from repro_torch.data.gamma_store import MANIFEST_NAME, GammaStore
from repro_torch.kernels import dispatch, ops
from repro_torch.launch.mesh import init_distributed, local_device
from repro_torch.runtime.elastic import WorkQueue
from repro_torch.runtime.faults import DeadLetter, FaultError
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
    ap.add_argument("--runtime", default="auto",
                    choices=["auto", "local", "multihost", "remote"],
                    help="where the processes live and how Γ bytes move "
                         "(auto = local)")
    ap.add_argument("--service", action="store_true",
                    help="run as one multi-batch job of the SamplingService")
    ap.add_argument("--service-workers", type=int, default=1,
                    help="service lanes")
    ap.add_argument("--service-fleet", action="store_true",
                    help="back each service lane with a persistent worker "
                         "process instead of a thread")
    return ap


def _say(*parts) -> None:
    """Print one line in one write, then flush: ranks of a job share a pipe,
    and ``print`` writes its parts and the newline apart (unbuffered, they
    reach the pipe apart and another rank's line can land between them)."""
    sys.stdout.write(" ".join(map(str, parts)) + "\n")
    sys.stdout.flush()


def main(argv=None) -> None:
    try:
        _main(argv)
    except FaultError as e:
        # a structured fault (a rotted Γ site, a dead-lettered batch):
        # a machine-readable record and exit code 2, not a stack trace
        record = {"fault": e.fault.to_dict(), "error": str(e)}
        if isinstance(e, DeadLetter):
            record["report"] = e.report.to_dict()
        sys.stderr.write(json.dumps(record, indent=1) + "\n")
        raise SystemExit(2)


def _main(argv=None) -> None:
    args = _parser().parse_args(argv)
    if args.service_fleet:
        args.service = True
    device = local_device(args.device)
    if args.samples % args.macro_batches:
        raise ValueError(f"--samples {args.samples} must divide over "
                         f"--macro-batches {args.macro_batches}")
    per_batch = args.samples // args.macro_batches
    created = init_distributed(device)      # a caller's group stays theirs
    runtime = None
    try:
        runtime = (api.RemoteRuntime(device=str(device))
                   if args.runtime == "remote" else
                   api.TorchMultiHostRuntime()
                   if args.runtime == "multihost" else api.LocalRuntime())
        # a remote runtime or fleet lanes dispatch whole batches: the
        # workers place the walk, there is no local mesh
        mesh = (None if args.runtime == "remote" or args.service_fleet
                else runtime.mesh(args.model_parallel, device))
        _run(args, mesh, device, runtime, per_batch)
        if dist.get_world_size() > 1:
            dist.barrier()              # every rank is done with the groups
    finally:
        if runtime is not None:
            runtime.close()
        if created:
            dist.destroy_process_group()


def _run(args, mesh, device, runtime, per_batch: int) -> None:
    lead = dist.get_rank() == 0
    _say(f"rank {dist.get_rank()}/{dist.get_world_size()} runtime "
          f"{runtime.name} mesh "
          f"{mesh.shape if mesh else None} scheme {args.scheme} device "
          f"{device}")
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
            _say(f"writing Γ store ({args.sites} sites) to {root}")
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
        _say("table1:", DB.table1_metrics(prof, args.chi))
    clamp = parse_clamp_arg(args.clamp) if args.clamp else None
    if clamp is not None:
        _say(f"clamp: {clamp} (clamped walks skip chain checkpoints — "
              f"macro-batch idempotence is the restart story)")
    scheme = args.scheme
    if mesh is None and scheme not in ("auto", "seq"):
        _say(f"the workers place the walk (--runtime {args.runtime}"
              f"{' --service-fleet' if args.service_fleet else ''}) — "
              f"overriding scheme {scheme!r} to auto")
        scheme = "auto"
    remote = runtime.name == "remote"
    config = api.SamplerConfig(
        scheme=scheme, kernels=args.kernels, compute_dtype=compute,
        runtime=runtime,
        backend=("auto" if remote else
                 "streamed" if args.stream else "inmem"),
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
    _say(f"pending macro batches: {queue.pending}")

    base = prng.key(args.seed + 1)
    t0 = time.perf_counter()
    with api.SamplingSession(source, config, device=device,
                             mesh=mesh) as session:
        plan = session.plan(per_batch)
        _say("plan:", plan)
        _say("why:", session.explain(per_batch))
        _say(f"kernel dispatch: requested={args.kernels!r} → resolved "
              f"{plan.kernels!r} (device={device}; registered ops: "
              f"{dispatch.registered_ops()})")

        lp_blocks: dict[int, np.ndarray] = {}
        worker_launches: dict[str, int] = {}

        def save_batch(b: int, out: np.ndarray, stats: dict) -> None:
            if lead:
                np.save(os.path.join(args.out, f"batch_{b:05d}.npy"),
                        out.astype(np.int8))
            if clamp is not None and stats.get("log_prob") is not None:
                lp_blocks[b] = np.asarray(stats["log_prob"],
                                          dtype=np.float64)
            for k, v in (stats.get("launches") or {}).items():
                worker_launches[k] = worker_launches.get(k, 0) + v
            _say(f"macro batch {b} done ({per_batch} samples)")

        if args.service:
            _run_service(args, session, base, queue, save_batch, device,
                         clamp is not None)
        else:
            session.run_queue(
                queue, per_batch, base, worker="cli",
                checkpoint_root=(None if clamp is not None or remote
                                 else _checkpoint_root(args.out)),
                on_batch=lambda b, out: save_batch(b, out, session.stats))
        if remote and runtime.worker is not None:
            worker_launches = dict(runtime.worker.launches)
        engine_stats = {k: v for k, v in session.stats.items()
                        if k != "log_prob"}
        if engine_stats:
            _say("streaming stats:", engine_stats)
        if lp_blocks:
            # ln P(clamped outcomes | earlier sites) per sample: the mean
            # of exp estimates the clamp's probability
            lp = np.concatenate([lp_blocks[b] for b in sorted(lp_blocks)])
            w = np.exp(lp)
            _say(f"clamp log_prob: n={lp.size} mean={lp.mean():.6f} "
                  f"min={lp.min():.6f} max={lp.max():.6f}  "
                  f"P(clamp) ≈ {w.mean():.6g}")
    if args.stream:
        source.close()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    _say("kernel launches:", json.dumps(ops.launch_counts()))
    if worker_launches:
        _say("worker kernel launches:", json.dumps(worker_launches))
    if runtime.name != "local":
        _say("runtime counters:", json.dumps(runtime.io_counters()))
    if not lead:
        return

    allb = [np.load(os.path.join(args.out, f"batch_{b:05d}.npy"))
            for b in range(n1)]
    samples = np.concatenate(allb, axis=0)
    mean_photons = samples.mean(axis=0)
    stats = {"n_samples": int(samples.shape[0]), "sites": args.sites,
             "chi": args.chi, "device": str(device), "scheme": plan.scheme,
             "backend": plan.backend,
             "mesh": mesh.shape if mesh else None,
             "walltime_s": time.perf_counter() - t0,
             "mean_photon_min": float(mean_photons.min()),
             "mean_photon_max": float(mean_photons.max())}
    with open(os.path.join(args.out, "stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    _say(json.dumps(stats, indent=1))


def _checkpoint_root(out: str) -> str:
    """Where this rank checkpoints its walks: every rank of a job walks
    (and checkpoints) its own copy of each batch's state."""
    if dist.get_world_size() == 1:
        return os.path.join(out, "chain_ckpt")
    return os.path.join(out, f"chain_ckpt_rank{dist.get_rank()}")


def _run_service(args, session, base, queue, save_batch, device,
                 clamped: bool) -> None:
    """The run as ONE job of a SamplingService: its batches over the
    lanes, each block saved and a progress line printed as it completes.
    The batch files equal the synchronous run's: a one-batch job draws on
    its key unchanged (``service.batch_key``), so batch 0's key is folded
    here."""
    from repro_torch.core import prng

    n1 = args.macro_batches
    job_key = prng.fold_in(base, 0) if n1 == 1 else base
    done = [b for b in range(n1) if b not in queue.pending]
    # fleet lanes have no walk here: skip_batches is their restart story
    ck_root = (None if args.service_fleet or clamped
               or session.plan(args.samples // n1).backend == "remote"
               else _checkpoint_root(args.out))
    pool = (api.WorkerPool(device=str(device)) if args.service_fleet
            else None)
    with api.SamplingService(workers=args.service_workers,
                             pool=pool) as svc:
        handle = svc.submit(session, n_samples=args.samples, key=job_key,
                            macro_batches=n1, skip_batches=done,
                            checkpoint_root=ck_root)
        for b, block in handle.stream():
            save_batch(b, block, handle.stats.get(b, {}))
            p, st = handle.progress, svc.stats()
            adm = st["admission"]
            lanes = " ".join(f"{n}:{c}" for n, c in
                             sorted(st["lane_batches"].items()))
            _say(f"[service] {p['done']}/{p['total']} batches "
                  f"(claims={p['claims']} requeues={p['requeues']} "
                  f"lanes={p['workers']}) queue_depth={st['queue_depth']} "
                  f"backpressure={'yes' if adm['backpressure'] else 'no'} "
                  f"(admitted={adm['admitted_jobs']} queued="
                  f"{adm['queued_jobs']}) per-lane: {lanes}")
        final = svc.stats()
        _say("[service] final:", handle.status(), json.dumps(final))
    if pool is not None:
        pool.close()


if __name__ == "__main__":
    main()