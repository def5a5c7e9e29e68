"""``python -m repro_torch.serve`` — the p-bit sampling service's demo loop.

Submits a small multi-tenant workload (random SK-style instances on a
1x1 and a 2x2 Chimera), optionally under a JSON fault schedule, drives
the service to completion, and prints the latency split and health
report.  Counterpart of ``python -m repro.serve``, with the same
arguments and ``--device`` (default ``cuda``: a machine without a GPU
needs ``--device cpu``).

Examples
--------
    python -m repro_torch.serve --requests 8 --tenants 3
    python -m repro_torch.serve --faultplan plan.json   # serve/faultplan.py
    python -m repro_torch.serve --device cpu --requests 4
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np


def build_requests(n_requests: int, n_tenants: int, chains: int,
                   n_sweeps: int, rng: np.random.Generator):
    from repro_torch.core.chimera import make_chimera
    from repro_torch.serve import SampleRequest

    g1 = make_chimera(1, 1)
    g2 = make_chimera(2, 2)
    reqs = []
    for i in range(n_requests):
        g = g1 if i % 2 == 0 else g2
        J = rng.integers(-40, 41, size=g.edges.shape[0], dtype=np.int32)
        h = rng.integers(-10, 11, size=g.n_nodes, dtype=np.int32)
        reqs.append(SampleRequest(
            tenant=f"tenant-{i % n_tenants}", graph=g, J_codes=J,
            h_codes=h, chains=chains, n_sweeps=n_sweeps))
    return reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Demo loop for the resilient multi-tenant p-bit "
                    "sampling service.")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--tenants", type=int, default=3)
    ap.add_argument("--chains", type=int, default=2,
                    help="chains per request (batched onto one launch)")
    ap.add_argument("--capacity", type=int, default=8,
                    help="chains capacity of one launch")
    ap.add_argument("--sweeps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--faultplan", type=Path, default=None,
                    help="JSON fault schedule (serve/faultplan.py format)")
    ap.add_argument("--device", default="cuda",
                    help="where the Sessions run (default cuda)")
    args = ap.parse_args(argv)

    from repro_torch.serve import (FaultInjector, FaultPlan, SamplerService,
                                   ShardHealthMonitor)

    injector = None
    monitor = None
    if args.faultplan is not None:
        plan = FaultPlan.from_json(args.faultplan.read_text())
        injector = FaultInjector(plan)
        monitor = ShardHealthMonitor()
        print(f"fault schedule: {plan.to_json()}")

    svc = SamplerService(seed=args.seed, capacity_chains=args.capacity,
                         monitor=monitor, injector=injector,
                         device=args.device)
    rng = np.random.default_rng(args.seed)
    tickets = [svc.submit(r) for r in build_requests(
        args.requests, args.tenants, args.chains, args.sweeps, rng)]
    svc.drain()

    print(f"{'tenant':<10} {'status':<10} {'bucket':<7} "
          f"{'queue_ms':>9} {'exec_ms':>8} {'attempts':>8}")
    for t in tickets:
        r = t.result()
        bucket = ("-" if r.bucket_shape is None
                  else f"{r.bucket_shape[0]}x{r.bucket_shape[1]}")
        print(f"{r.tenant:<10} {r.status:<10} {bucket:<7} "
              f"{r.queue_s * 1e3:>9.1f} {r.exec_s * 1e3:>8.1f} "
              f"{r.attempts:>8}")
    print(json.dumps(svc.healthz(), indent=2, sort_keys=True))
    ok = all(t.result().status == "ok" for t in tickets)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
