#!/usr/bin/env python3
"""Where a fresh process's first train step spends its time.

Run from the root of a checkout, on a machine with a CUDA device:

    python3 scripts/train_first_step.py [--arch whisper-small] [--batch 8]
                                        [--seq 448] [--steps 3] [--top 25]

In one new process: the imports, the card's context, the weights, then
``--steps`` train steps of ``launch.steps`` at the config's remat policy,
each split into the batch (``synthetic_token_stream`` and the stub
frontend's inputs), the forward and backward (``steps.loss_and_grads``)
and the adamw update, each synced.  The first forward and backward runs
under cProfile, whose ``--top`` entries by cumulative time are printed
(the modules it imports show there).  Ends with the card's name and power
limit as ``nvidia-smi`` gives them.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import pstats
import subprocess
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.data.tokens import synthetic_token_stream  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.train import stub_inputs  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="whisper-small", choices=configs.ARCHS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=448)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()
    print(f"imports {time.perf_counter() - T0:.3f} s", flush=True)

    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    print(f"context {time.perf_counter() - t:.3f} s", flush=True)
    cfg = configs.get_config(args.arch)
    t = time.perf_counter()
    params = T.init_params(0, cfg, dev)
    opt = optimizers.adamw(1e-3)
    state = opt.init(params)
    torch.cuda.synchronize()
    print(f"weights and adamw state {time.perf_counter() - t:.3f} s "
          f"(remat {cfg.remat_policy})", flush=True)

    stream = synthetic_token_stream(0, cfg.vocab, args.batch, args.seq, dev)
    for i in range(args.steps):
        t = time.perf_counter()
        batch = {**stream(i), **stub_inputs(cfg, args.batch, i, dev)}
        torch.cuda.synchronize()
        t_batch = time.perf_counter() - t
        prof = cProfile.Profile() if i == 0 else None
        t = time.perf_counter()
        if prof:
            prof.enable()
        _, _, grads = steps.loss_and_grads(params, batch, cfg)
        torch.cuda.synchronize()
        if prof:
            prof.disable()
        t_grad = time.perf_counter() - t
        t = time.perf_counter()
        opt.update(grads, state, params)
        torch.cuda.synchronize()
        print(f"step {i + 1}: batch {t_batch:.3f} s, forward + backward "
              f"{t_grad:.3f} s, update {time.perf_counter() - t:.3f} s, "
              f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB",
              flush=True)
        if prof:
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("cumulative") \
                .print_stats(args.top)
            print(out.getvalue(), flush=True)
        del grads
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
