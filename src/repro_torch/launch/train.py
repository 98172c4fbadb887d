"""End-to-end training entry point with checkpoints and auto-resume.

Mirrors ``repro.launch.train``.  Fault-tolerance contract:
  * a checkpoint every ``--ckpt-every`` steps (atomic, the last 3 kept,
    the reference's format: ``checkpoint.store``);
  * on start, it resumes from the latest checkpoint under ``--ckpt-dir``;
  * batches are a function of (seed, step) (``data.tokens``), and the stub
    frontends' ``frames``/``patches`` of the step (``prng.normal`` on
    ``fold_in(key(1 | 2), step)``, drawn in fp32 and cast to the model's
    dtype), so a resumed run reads the stream an uninterrupted run would
    have read: restart-exact training.

Every run builds the ("data", "model") mesh over the job's ranks
(``launch.mesh.make_host_mesh(model=--model-parallel)``; a ``torchrun``
job's, or a one-rank group in this process: NCCL on the card, gloo on the
CPU), as the reference builds its host mesh.  Every family trains on it:
each rank holds its tiles of the seeded weights and of their optimizer
state under the sharding policy (``launch.steps``, FSDP off as the
reference's CLI has it) and of the (seed, step) batch (and of the stub
frontend's ``frames`` or ``patches``), and runs the sharded
``make_train_step``.  A checkpoint holds whole leaves: the tiles are
gathered and rank 0 writes them; a resume loads whole leaves and takes its
tiles, so a checkpoint of one world size resumes on another.  Only rank 0
prints.  On the card unless ``--device cpu``.  ``--stop-at N`` ends the
run after step N with the flags of a longer run, as a preemption would:
its resume is held to the uninterrupted run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --smoke --device cpu --steps 50 --batch 4 --seq 32 --ckpt-dir DIR
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch granite-3-2b --smoke --device cpu --model-parallel 2
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch deepseek-v3-671b --smoke --device cpu --model-parallel 2
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch zamba2-7b --smoke --device cpu --model-parallel 2
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch whisper-small --smoke --device cpu --model-parallel 2
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.core import prng
from repro_torch.data.tokens import synthetic_token_stream
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import (data_axis_names, init_distributed,
                                     local_device, make_host_mesh)
from repro_torch.models import transformer as T
from repro_torch.models.common import clear_mesh_axes, set_mesh_axes
from repro_torch.optim import optimizers, schedule

STUB_KEYS = {"encdec": ("frames", 1, "enc_len"),
             "vlm": ("patches", 2, "n_patches")}


def stub_inputs(cfg: T.ModelConfig, batch: int, step: int,
                device) -> dict:
    """The stub frontend's embeddings for ``step``: encdec's ``frames``
    (B, enc_len, dm) or the VLM's ``patches`` (B, n_patches, dm)."""
    if cfg.family not in STUB_KEYS:
        return {}
    name, seed, length = STUB_KEYS[cfg.family]
    shape = (batch, getattr(cfg, length), cfg.d_model)
    x = prng.normal(prng.fold_in(prng.key(seed), step), shape,
                    torch.float32, device)
    return {name: x.to(cfg.dtype)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu to train on the CPU (default: the card)")
    ap.add_argument("--stop-at", type=int, default=None,
                    help="end the run after this step, as a preemption "
                    "would (the schedule still spans --steps)")
    args = ap.parse_args(argv)

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    dev = local_device(args.device)
    created = init_distributed(dev)
    try:
        return _train(args, cfg, dev)
    finally:
        clear_mesh_axes()
        if created:
            dist.destroy_process_group()


def _train(args, cfg: T.ModelConfig, dev: torch.device) -> dict:
    mesh = make_host_mesh(model=args.model_parallel, device=dev)
    world = dist.get_world_size()
    lead = dist.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    say(f"device: {dev}  mesh: {mesh.shape}  arch: {cfg.name}  "
        f"family: {cfg.family}")

    opt = optimizers.optimizer_for(cfg, schedule.cosine_schedule(
        args.lr, warmup=max(args.steps // 20, 1), total=args.steps))
    params = T.init_params(args.seed, cfg, device=dev)
    opt_state = opt.init(params)
    start_step = 0
    if args.ckpt_dir and store.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start_step, _ = store.load_checkpoint(
            args.ckpt_dir, (params, opt_state))
        say(f"resumed from step {start_step}")
    set_mesh_axes(data_axis_names(mesh), mesh=mesh)
    psh = steps_mod.param_shardings(mesh, params, T.param_specs(cfg),
                                    fsdp=False)
    osh = steps_mod.opt_state_shardings(mesh, opt_state, psh)
    opt_state = steps_mod.shard_opt_state(opt_state, osh, mesh)
    params = steps_mod.shard_params(params, psh, mesh)
    batch_sh = None

    def save(step: int) -> None:
        whole = (steps_mod.unshard_params(params, mesh),
                 steps_mod.unshard_opt_state(opt_state, osh, mesh))
        if lead:
            store.save_checkpoint(args.ckpt_dir, step, whole)
        if world > 1:
            dist.barrier()

    step_fn = steps_mod.make_train_step(cfg, opt)
    batch_at = synthetic_token_stream(args.seed, cfg.vocab, args.batch,
                                      args.seq, dev)
    metrics = {}
    t_last = time.perf_counter()
    stop = args.steps if args.stop_at is None else min(args.stop_at,
                                                        args.steps)
    for step in range(start_step, stop):
        batch = {**batch_at(step), **stub_inputs(cfg, args.batch, step, dev)}
        batch_sh = batch_sh or steps_mod.batch_shardings(mesh, batch)
        batch = steps_mod.shard_batch(batch, batch_sh, mesh)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % 10 == 0 or step == start_step:
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            say(f"step {step + 1:5d}  loss {float(metrics['loss']):8.4f}  "
                f"gnorm {float(metrics['gnorm']):8.3f}  ({dt:.2f}s)",
                flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    say("done")
    return {k: float(v) for k, v in metrics.items()}


if __name__ == "__main__":
    main()
