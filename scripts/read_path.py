#!/usr/bin/env python3
"""Read rate of one GammaStore site file into pinned host memory, by path.

Run from the root of a checkout, on a machine with a CUDA device (pinned
memory needs one):

    python3 scripts/read_path.py [--sites 4] [--chi 10000] [--d 4]
                                 [--rounds 3] [--dir build/read_path]

Writes ``--sites`` bf16 sites of χ × χ × d (jiuzhang2's 800 MB a site at
the defaults) with ``GammaStore.put``, then reads each site in turns, the
same files for every path, so every path reads from the same page cache:

* ``store``: ``GammaStore._read_raw`` with ``pin_memory`` on — the file
  read once into a pinned buffer, Γ located in it, its CRC-32 checked;
* ``np_load_bytes_pin``: the file's bytes read, ``np.load`` over them (as
  the JAX package reads a site), then ``torch.from_numpy(Γ).pin_memory()``;
* ``np_load_path_pin``: ``np.load(path)``, then ``pin_memory()``;
* ``readinto``: the file read into a pinned buffer, nothing else;
* ``crc32``: ``zlib.crc32`` over Γ's bytes already in memory.

Prints one JSON object: each path's GB/s (Γ bytes over seconds) per read
and their medians, then the card's name and power limit as ``nvidia-smi``
gives them.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.data.gamma_store import GammaStore  # noqa: E402


def _pin(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a).pin_memory()


def read_store(store, i, path):
    raw = store._read_raw(i)
    return raw.nbytes


def read_np_load_bytes_pin(store, i, path):
    with open(path, "rb") as fh:
        data = fh.read()
    with np.load(io.BytesIO(data)) as z:
        g, _ = z["gamma"], z["lam"]
    return _pin(g).numel() * g.itemsize


def read_np_load_path_pin(store, i, path):
    with np.load(path) as z:
        g, _ = z["gamma"], z["lam"]
    return _pin(g).numel() * g.itemsize


def read_readinto(store, i, path):
    with open(path, "rb") as fh:
        buf = torch.empty(os.fstat(fh.fileno()).st_size, dtype=torch.uint8,
                          pin_memory=True)
        return fh.readinto(memoryview(buf.numpy()))


PATHS = {"store": read_store, "np_load_bytes_pin": read_np_load_bytes_pin,
         "np_load_path_pin": read_np_load_path_pin,
         "readinto": read_readinto}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sites", type=int, default=4)
    ap.add_argument("--chi", type=int, default=10_000)
    ap.add_argument("--d", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dir", default=str(ROOT / "build" / "read_path"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("read_path: pinned memory needs a CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.dir, exist_ok=True)
    store = GammaStore(args.dir, torch.bfloat16, torch.float64)
    store.pin_memory = True
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    for i in range(args.sites):
        g = torch.randn((args.chi, args.chi, args.d), generator=gen,
                        device="cuda", dtype=torch.float32)
        store.put(i, g, torch.ones(args.chi, dtype=torch.float64))
        del g
    write_s = time.perf_counter() - t0
    rates: dict[str, list[float]] = {k: [] for k in (*PATHS, "crc32")}
    for _ in range(args.rounds):
        for i in range(args.sites):
            path = store._path(i)
            for name, fn in PATHS.items():
                t = time.perf_counter()
                nbytes = fn(store, i, path)
                rates[name].append(nbytes / (time.perf_counter() - t) / 1e9)
            g = store._read_raw(i)
            member = memoryview(g.buf.numpy())[g.offset:g.offset + g.nbytes]
            t = time.perf_counter()
            zlib.crc32(member)
            rates["crc32"].append(g.nbytes / (time.perf_counter() - t) / 1e9)
            del g, member
    store.close()
    for i in range(args.sites):
        os.remove(store._path(i))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "site_bytes": args.chi * args.chi * args.d * 2, "sites": args.sites,
        "rounds": args.rounds, "write_s": write_s,
        "zlib": zlib.ZLIB_RUNTIME_VERSION, "numpy": np.__version__,
        "median_gbps": {k: statistics.median(v) for k, v in rates.items()},
        "gbps": rates}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
