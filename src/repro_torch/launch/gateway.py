"""Gateway launcher: the multi-tenant HTTP front door as a process.

Wires the serving stack — `SamplingService` lanes (threads or a fleet
`WorkerPool`), the tenant table, the content-addressed result cache and
the `repro_torch.obs` metrics registry — behind one
`repro_torch.serve.Gateway`, prints the bound URL and ticks a stats line.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.gateway --port 8752 \\
      --workers 2 --tenants tenants.json --store-root /data/stores \\
      --cache-dir /tmp/fastmps_cache \\
      --max-cache-bytes 1000000000 --max-active-bytes 8e9

With ``--store-root``, clients name stores relative to that directory
(``{"store": "demo_chain"}``) and can never reach outside it; without it
the gateway runs in trusted single-user mode, where ``store`` is a server
path.  Always set a root when serving untrusted tenants.  Jobs run on the
card unless ``--device cpu`` is given (a fleet's workers too).

Smoke mode (an ephemeral port, a demo store, exit after N seconds):
  PYTHONPATH=src python -m repro_torch.launch.gateway --port 0 \\
      --serve-s 20 --demo-store /tmp/gw_demo --sites 8 --chi 4
"""
from __future__ import annotations

import argparse
import sys
import time


def _build_demo_store(root: str, sites: int, chi: int, d: int) -> None:
    import torch

    from repro_torch.core import mps as M
    from repro_torch.core import prng
    from repro_torch.data.gamma_store import GammaStore

    mps = M.random_linear_mps(prng.key(0), sites, chi, d, device="cpu")
    with GammaStore(root, storage_dtype=torch.float64,
                    compute_dtype=torch.float64) as store:
        store.write_mps(mps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8752,
                    help="0 = ephemeral (the bound port is printed)")
    ap.add_argument("--workers", type=int, default=2,
                    help="service lanes")
    ap.add_argument("--fleet", action="store_true",
                    help="persistent worker processes instead of threads")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; without a GPU the default "
                         "fails the first job")
    ap.add_argument("--tenants", default=None,
                    help="tenants.json (see repro_torch.serve.tenancy); "
                         "omitted = open single-tenant mode")
    ap.add_argument("--store-root", default=None,
                    help="confine client store names beneath this "
                         "directory; omitted = trusted mode (store is a "
                         "server path)")
    ap.add_argument("--cache-dir", default=None,
                    help="result-cache disk store (omitted = memory only)")
    ap.add_argument("--max-cache-bytes", type=float, default=None,
                    help="LRU budget for --cache-dir")
    ap.add_argument("--max-active-bytes", type=float, default=None,
                    help="service admission budget (perfmodel Eq. 3)")
    ap.add_argument("--stats-every", type=float, default=10.0,
                    help="seconds between live stats lines (0 = quiet)")
    ap.add_argument("--serve-s", type=float, default=None,
                    help="exit after N seconds (smoke runs); default: "
                         "forever")
    ap.add_argument("--demo-store", default=None,
                    help="write a random demo GammaStore here at startup")
    ap.add_argument("--sites", type=int, default=8)
    ap.add_argument("--chi", type=int, default=4)
    ap.add_argument("--d", type=int, default=3)
    args = ap.parse_args(argv)

    from repro_torch import api
    from repro_torch.obs import MetricsRegistry, instrument_service
    from repro_torch.serve import Gateway, ResultCache, TenantTable

    if args.demo_store:
        _build_demo_store(args.demo_store, args.sites, args.chi, args.d)
        print(f"demo store: {args.demo_store}", flush=True)

    tenants = (TenantTable.from_json(args.tenants) if args.tenants
               else TenantTable())
    if args.tenants and not args.store_root:
        print("warning: --tenants without --store-root lets every tenant "
              "name arbitrary server paths as stores", file=sys.stderr)
    cache = ResultCache(cache_dir=args.cache_dir,
                        max_bytes=(None if args.max_cache_bytes is None
                                   else int(args.max_cache_bytes)))
    registry = MetricsRegistry()
    pool = None
    if args.fleet:
        from repro_torch.runtime.transport import WorkerPool
        pool = WorkerPool(device=args.device)
    with api.SamplingService(workers=args.workers, pool=pool,
                             device=args.device,
                             max_active_bytes=args.max_active_bytes) as svc:
        instrument_service(svc, registry)
        with Gateway(svc, tenants=tenants, cache=cache, registry=registry,
                     host=args.host, port=args.port,
                     store_root=args.store_root) as gw:
            print(f"gateway listening on {gw.url}", flush=True)
            deadline = (None if args.serve_s is None
                        else time.monotonic() + args.serve_s)
            next_stats = time.monotonic() + (args.stats_every or 1e18)
            try:
                while deadline is None or time.monotonic() < deadline:
                    time.sleep(0.2)
                    if time.monotonic() >= next_stats:
                        next_stats = time.monotonic() + args.stats_every
                        st = gw.stats()
                        print(f"[stats] requests={st['gateway']['requests']} "
                              f"jobs={st['gateway']['by_state']} "
                              f"cache(hit={st['cache']['hits']} "
                              f"miss={st['cache']['misses']} "
                              f"attach={st['cache']['attaches']}) "
                              f"queue_depth={st['service']['queue_depth']} "
                              f"backpressure="
                              f"{st['service']['admission']['backpressure']}",
                              flush=True)
            except KeyboardInterrupt:
                pass
            st = gw.stats()
            print(f"gateway exit: {st['gateway']['requests']} requests, "
                  f"{st['cache']['hits']} cache hits", flush=True)
    if pool is not None:
        pool.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
