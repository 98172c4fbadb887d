"""Scenario-runner CLI of the port: named end-to-end workloads with
pass/fail scoring (``repro_torch.workloads.scenarios``).

Usage (on the card; ``--device cpu`` runs the plain PyTorch path):
  PYTHONPATH=src python -m repro_torch.launch.scenarios --list
  PYTHONPATH=src python -m repro_torch.launch.scenarios --scenario all
  PYTHONPATH=src python -m repro_torch.launch.scenarios \
      --scenario conditional_marginals --json traj.json

The exit code is non-zero when any scenario fails its threshold.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="run registered workload scenarios "
                    "(repro_torch.workloads)")
    ap.add_argument("--scenario", default="all",
                    help="scenario name, or 'all' (default)")
    ap.add_argument("--list", action="store_true",
                    help="list registered scenarios and exit")
    ap.add_argument("--json", default=None,
                    help="trajectory file to append records to ('' or "
                         "none: no file)")
    ap.add_argument("--samples", type=int, default=0,
                    help="override the per-scenario sample budget")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="inmem",
                    choices=["inmem", "streamed"])
    ap.add_argument("--scheme", default="seq", choices=["seq", "dp"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a GPU the default "
                         "raises")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device
    from repro_torch.workloads import scenarios as SC

    catalogue = SC.available_scenarios()
    if args.list:
        for name, summary in catalogue.items():
            print(f"{name:26s} {summary}")
        return 0

    names = sorted(catalogue) if args.scenario == "all" else [args.scenario]
    for n in names:
        if n not in catalogue:
            print(f"unknown scenario {n!r}; --list shows the registry",
                  file=sys.stderr)
            return 2

    device = resolve_device(args.device)
    cfg_kwargs = dict(seed=args.seed, backend=args.backend,
                      scheme=args.scheme, json_path=args.json,
                      device=str(device))
    if args.samples:
        cfg_kwargs["n_samples"] = args.samples

    failures = 0
    for name in names:
        result = SC.run_scenario(name, SC.ScenarioConfig(**cfg_kwargs))
        status = "PASS" if result.passed else "FAIL"
        print(f"[{status}] {name}: score={result.score:.6g} "
              f"(threshold {result.threshold:g}) wall={result.wall_s:.2f}s "
              f"device={device}")
        print("        " + json.dumps(result.metrics, default=str))
        failures += 0 if result.passed else 1
    if failures:
        print(f"{failures}/{len(names)} scenarios failed", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
