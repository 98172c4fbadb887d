"""The dry run's tables (§Dry-run, §Roofline) from the port's cached JSONs
(experiments/dryrun_torch/*.json, written by ``launch/dryrun.py``), the
JAX package's ``launch/report.py`` over the port's fields: FLOPs, wire
bytes and collectives counted by ``launch/costs.py`` on fake tensors, the
roofline on NVIDIA H100 80GB HBM3 constants at 700 W.

    PYTHONPATH=src python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_bytes(b: float) -> str:
    if b >= 1e12:
        return f"{b / 1e12:.1f}TB"
    if b >= 1e9:
        return f"{b / 1e9:.1f}GB"
    if b >= 1e6:
        return f"{b / 1e6:.1f}MB"
    return f"{b / 1e3:.0f}KB"


def fmt_t(t: float) -> str:
    if t >= 1.0:
        return f"{t:.2f}s"
    if t >= 1e-3:
        return f"{t * 1e3:.1f}ms"
    return f"{t * 1e6:.0f}µs"


def load(dirname: str) -> list[dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def dryrun_table(rows: list[dict], mesh: str | None = None) -> str:
    out = ["| arch | shape | mesh | chips | status | mem/dev | FLOPs/dev | "
           "wire B/dev | #coll | compile |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if mesh and r.get("mesh") != mesh:
            continue
        base = f"| {r['arch']} | {r['shape']} | {r['mesh']} "
        if "skipped" in r:
            out.append(base + f"| — | SKIP ({r['skipped'][:40]}…) | | | | | |")
            continue
        if "error" in r:
            out.append(base + f"| — | FAIL {r['error'][:40]} | | | | | |")
            continue
        h = r["hlo"]
        ncoll = sum(r["hlo"]["n_collectives"].values())
        out.append(
            base + f"| {r['n_chips']} | ok "
            f"| {fmt_bytes(r['bytes_per_device']['peak_estimate'])} "
            f"| {h['flops_per_device']:.2e} "
            f"| {fmt_bytes(h['collective_wire_bytes_per_device'])} "
            f"| {ncoll:.0f} | {r['compile_s']:.0f}s |")
    return "\n".join(out)


def roofline_table(rows: list[dict], mesh: str = "16x16") -> str:
    out = ["| arch | shape | t_compute | t_memory | t_collective | "
           "bottleneck | MODEL_FLOPS | counted FLOPs | useful |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("mesh") != mesh or "roofline" not in r:
            continue
        rf = r["roofline"]
        out.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {fmt_t(rf['t_compute_s'])} | {fmt_t(rf['t_memory_s'])} "
            f"| {fmt_t(rf['t_collective_s'])} | **{rf['bottleneck']}** "
            f"| {rf['model_flops']:.2e} | {rf['hlo_flops']:.2e} "
            f"| {rf['useful_ratio']:.2f} |")
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--kind", default="roofline",
                    choices=["roofline", "dryrun"])
    args = ap.parse_args(argv)
    rows = load(args.dir)
    if args.kind == "roofline":
        print(roofline_table(rows, args.mesh or "16x16"))
    else:
        print(dryrun_table(rows, args.mesh))


if __name__ == "__main__":
    main()
