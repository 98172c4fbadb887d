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

One device: ``--model-parallel`` other than 1 raises (the sharding policy
is ROADMAP.md §1 row 19).  On the card unless ``--device cpu``.
``--stop-at N`` ends the run after step N with the flags of a longer run,
as a preemption would: its resume is held to the uninterrupted run.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
      --smoke --device cpu --steps 50 --batch 4 --seq 32 --ckpt-dir DIR
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
from repro_torch.checkpoint import store
from repro_torch.core import prng
from repro_torch.data.tokens import synthetic_token_stream
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.models import transformer as T
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
    if args.model_parallel != 1:
        raise ValueError("--model-parallel: the port trains on one device; "
                         "the sharding policy is ROADMAP.md §1 row 19")

    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    dev = resolve_device(args.device)
    print(f"device: {dev}  arch: {cfg.name}  family: {cfg.family}")

    opt = optimizers.optimizer_for(cfg, schedule.cosine_schedule(
        args.lr, warmup=max(args.steps // 20, 1), total=args.steps))
    params = T.init_params(args.seed, cfg, device=dev)
    opt_state = opt.init(params)
    start_step = 0
    if args.ckpt_dir and store.latest_step(args.ckpt_dir) is not None:
        (params, opt_state), start_step, _ = store.load_checkpoint(
            args.ckpt_dir, (params, opt_state))
        print(f"resumed from step {start_step}")

    step_fn = steps_mod.make_train_step(cfg, opt)
    batch_at = synthetic_token_stream(args.seed, cfg.vocab, args.batch,
                                      args.seq, dev)
    metrics = {}
    t_last = time.perf_counter()
    stop = args.steps if args.stop_at is None else min(args.stop_at,
                                                        args.steps)
    for step in range(start_step, stop):
        batch = {**batch_at(step), **stub_inputs(cfg, args.batch, step, dev)}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if (step + 1) % 10 == 0 or step == start_step:
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            print(f"step {step + 1:5d}  loss {float(metrics['loss']):8.4f}  "
                  f"gnorm {float(metrics['gnorm']):8.3f}  ({dt:.2f}s)",
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            store.save_checkpoint(args.ckpt_dir, step + 1,
                                  (params, opt_state))
    print("done")
    return {k: float(v) for k, v in metrics.items()}


if __name__ == "__main__":
    main()
