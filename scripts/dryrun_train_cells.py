"""The dry run's train_4k cells of the dense family in both packages, side
by side: the port's ``launch.dryrun.run_cell`` (fake tensors, this
process) and the JAX package's ``lower_cell`` + ``analyze_cell`` in a child
with 512 placeholder CPU devices, its production meshes built with Auto
axes (on jax 0.9.0 ``jax.make_mesh``'s Explicit axes make ``lower_cell``
raise ``ShardingTypeError``; ``tests/test_torch_dryrun_lm.py`` swaps the
mesh the same way).  Prints one markdown row a cell: the port's roofline
terms, bound and memory a device, its FLOPs a device and collective
counts, and the reference's FLOPs and counts.  CPU only, no card; about
10 s a cell.

Usage:
  PYTHONPATH=src python scripts/dryrun_train_cells.py [--arch A ...]
      [--mesh single multi] [--remat-block 0 4] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

from repro_torch.launch import dryrun as DR

REFERENCE = """
import json, sys
import jax
from jax.sharding import AxisType
from repro.launch import dryrun as D

def auto_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))

D.make_production_mesh = auto_mesh
out = {}
for arch, mk, rb in json.loads(sys.argv[1]):
    compiled, meta = D.lower_cell(arch, "train_4k", mk == "multi", rb)
    r = D.analyze_cell(compiled, meta)
    out[f"{arch}/{mk}/{rb}"] = {
        "flops": r["hlo"]["flops_per_device"],
        "n_collectives": r["hlo"]["n_collectives"],
        "arguments": r["bytes_per_device"]["arguments"],
        "peak": r["bytes_per_device"]["peak_estimate"]}
    del compiled
print(json.dumps(out))
"""


def _counts(n: dict) -> str:
    return ", ".join(f"{k} {int(v)}" for k, v in sorted(n.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="*", default=[
        a for a in DR.configs.ARCHS
        if DR.configs.get_config(a).family == "dense"])
    ap.add_argument("--mesh", nargs="*", default=["single", "multi"])
    ap.add_argument("--remat-block", nargs="*", type=int, default=[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cells = [(a, m, rb) for a in args.arch for rb in args.remat_block
             for m in args.mesh]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    env = dict(os.environ, PYTHONPATH=src, JAX_PLATFORMS="cpu")
    child = subprocess.Popen([sys.executable, "-c", REFERENCE,
                              json.dumps(cells)], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    out = args.out or tempfile.mkdtemp()
    port = {f"{a}/{m}/{rb}": DR.run_cell(a, "train_4k", m, force=True,
                                         out_root=out, remat_block=rb,
                                         device="cpu")
            for a, m, rb in cells}
    stdout, stderr = child.communicate()
    if child.returncode:
        print(stderr[-3000:], file=sys.stderr)
        return 1
    ref = json.loads(stdout.strip().splitlines()[-1])
    print("| cell | t_compute | t_memory | t_collective | bound | mem/dev "
          "| FLOPs/dev (port = ref) | args (port = ref) | port collectives "
          "| reference collectives | ref peak |")
    print("| --- " * 11 + "|")
    bad = 0
    for key, r in port.items():
        if "error" in r:
            print(f"| {key} | error: {r['error']} |")
            bad += 1
            continue
        w, rf = ref[key], r["roofline"]
        f, a = r["hlo"]["flops_per_device"], r["bytes_per_device"][
            "arguments"]
        same = f == w["flops"] and a == w["arguments"]
        bad += not same
        print(f"| {key} | {rf['t_compute_s'] * 1e3:.1f} ms "
              f"| {rf['t_memory_s'] * 1e3:.1f} ms "
              f"| {rf['t_collective_s'] * 1e3:.1f} ms | {rf['bottleneck']} "
              f"| {r['bytes_per_device']['peak_estimate'] / 1e9:.1f} GB "
              f"| {f:.5e} ({'=' if f == w['flops'] else w['flops']}) "
              f"| {a} ({'=' if a == w['arguments'] else w['arguments']}) "
              f"| {_counts(r['hlo']['n_collectives'])} "
              f"| {_counts(w['n_collectives'])} | {w['peak'] / 1e9:.1f} GB |",
              flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
