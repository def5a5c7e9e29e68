"""Multi-tenant p-bit sampling service, end to end.

Three tenants share one `repro_torch.serve.SamplerService`: an AND-gate
style clamped inference problem and two random instances, all embedded
into shape buckets and multiplexed onto the chains axis of shared
launches — then the same traffic is replayed under a scripted link flap
+ straggler to show the resilience path leaves results untouched.  A
final hot-swap demo retargets a warm bucket with fresh couplings every
call through `Session.sample_program` (the program as a runtime operand)
and prints the measured swap latency against programming the chip
eagerly (`program_edges` + `sample`) and a full Session rebuild.  Twin of
``examples/serve_pbit.py`` on the PyTorch/CUDA port: every launch of a
bucket is one launch of the slot-layout kernel on the card.

Run:  PYTHONPATH=src python examples_torch/serve_pbit.py [--device cpu]
      (on the GPU unless ``--device cpu``)
Quick CI mode:  REPRO_EXAMPLE_QUICK=1 (smaller sweep counts)
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import api
from repro_torch.core.chimera import make_chimera
from repro_torch.serve import (
    FaultEvent,
    FaultInjector,
    FaultPlan,
    SampleRequest,
    SamplerService,
    ShardHealthMonitor,
    make_bucket_graph,
)

ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ap.add_argument("--device", default="cuda")
DEVICE = ap.parse_args().device
QUICK = bool(os.environ.get("REPRO_EXAMPLE_QUICK"))
SWEEPS = 8 if QUICK else 64


def build_requests():
    """Three tenants, two buckets, one shared chip program per bucket.

    The first tenant runs clamped inference — a ferromagnetic instance
    with its first two spins pinned to query data per chain (the
    chains-axis multiplexing model: same chip, per-chain inputs)."""
    g_small = make_chimera(1, 1)
    J_ferro = np.full(g_small.edges.shape[0], 40, np.int32)
    h_zero = np.zeros(g_small.n_nodes, np.int32)
    mask = np.zeros(g_small.n_nodes, bool)
    mask[:2] = True
    queries = np.zeros((4, g_small.n_nodes), np.float32)
    queries[:, 0] = (1, 1, -1, -1)
    queries[:, 1] = (1, -1, 1, -1)
    g_big = make_chimera(2, 2)
    rng = np.random.default_rng(0)
    J_big = rng.integers(-40, 41, size=g_big.edges.shape[0],
                         dtype=np.int32)
    h_big = rng.integers(-10, 11, size=g_big.n_nodes, dtype=np.int32)
    return [
        SampleRequest(tenant="inference-inc", graph=g_small,
                      J_codes=J_ferro, h_codes=h_zero, chains=4,
                      clamp_mask=mask, clamp_values=queries,
                      n_sweeps=SWEEPS),
        SampleRequest(tenant="anneal-co", graph=g_big, J_codes=J_big,
                      h_codes=h_big, chains=2, n_sweeps=SWEEPS),
        SampleRequest(tenant="sampling-ltd", graph=g_big, J_codes=J_big,
                      h_codes=h_big, chains=2, n_sweeps=SWEEPS),
    ]


def run(injector=None, monitor=None):
    svc = SamplerService(seed=0, capacity_chains=8, injector=injector,
                         monitor=monitor, backoff_s=0.01,
                         max_backoff_s=0.1, device=DEVICE)
    tickets = [svc.submit(r) for r in build_requests()]
    svc.drain()
    return svc, [t.result() for t in tickets]


def hot_swap_demo():
    """Runtime weight streaming on a warm bucket Session: new couplings
    every call, one Session throughout."""
    svc = SamplerService(seed=0, capacity_chains=8, device=DEVICE)
    g = make_bucket_graph(2, 2)
    ses = api.Session(svc.bucket_spec(g))
    betas = torch.ones((SWEEPS,), dtype=torch.float32, device=ses.device)
    m0 = ses.random_spins(ses.generator(1))
    ns = ses.noise_state(ses.generator(2))
    rng = np.random.default_rng(0)

    def codes():
        return (rng.integers(-40, 41, g.edges.shape[0]).astype(np.int32),
                rng.integers(-10, 11, g.n_nodes).astype(np.int32))

    def sync(x):
        if ses.device.type == "cuda":
            torch.cuda.synchronize()
        return x

    def med(fn, n=5):
        ts = []
        for _ in range(n):
            t0 = time.perf_counter()
            sync(fn())
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2] * 1e3

    # warm both paths once (the first call loads the kernel library)
    J0, h0 = codes()
    sync(ses.sample_program(ses.make_program(J0, h0), m0, ns, betas)[0])
    sync(ses.sample(ses.program_edges(J0, h0), m0, ns, betas)[0])

    # hot swap: fresh couplings every call, program as runtime operand
    swap_ms = med(lambda: ses.sample_program(
        ses.make_program(*codes()), m0, ns, betas)[0])
    # program the chip through the analog model eagerly, then sample
    eager_ms = med(lambda: ses.sample(ses.program_edges(*codes()), m0, ns,
                                      betas)[0])
    # full rebuild: a Session per program instance
    t0 = time.perf_counter()
    fresh = api.Session(svc.bucket_spec(g))
    sync(fresh.sample(fresh.program_edges(*codes()), m0, ns, betas)[0])
    rebuild_ms = (time.perf_counter() - t0) * 1e3

    print(f"=== hot swap: new couplings per call, warm 2x2 bucket "
          f"({ses.backend} on {ses.device}) ===")
    print(f"  program swap (sample_program):   {swap_ms:8.2f} ms/call")
    print(f"  per-program eager (program_edges + sample): "
          f"{eager_ms:8.2f} ms/call")
    print(f"  session rebuild + first call:    {rebuild_ms:8.2f} ms")
    print(f"  swap vs rebuild: {rebuild_ms / max(swap_ms, 1e-9):.1f}x")


def main():
    print("=== clean run ===")
    svc, clean = run()
    for r in clean:
        print(f"  {r.tenant:<14} {r.status:<4} bucket="
              f"{r.bucket_shape[0]}x{r.bucket_shape[1]} "
              f"launch={r.launch_seq} offset={r.chain_offset} "
              f"exec={r.exec_s * 1e3:.1f}ms")
    shared = clean[1].launch_seq == clean[2].launch_seq
    print(f"  tenants anneal-co + sampling-ltd shared one launch: "
          f"{shared}")
    print(f"  cache: {svc.cache.stats()}")

    print("=== same traffic under a link flap + straggler ===")
    plan = FaultPlan.make([
        FaultEvent(step=0, kind="link_flap", flaps=2),
        FaultEvent(step=1, kind="straggler", delay_s=0.05),
    ])
    svc2, faulted = run(FaultInjector(plan), ShardHealthMonitor())
    identical = all(np.array_equal(a.spins, b.spins)
                    for a, b in zip(clean, faulted))
    print(f"  retries absorbed: "
          f"{svc2.metrics['transient_retries']} transient")
    print(f"  results bit-identical to clean run: {identical}")
    if not identical:
        raise AssertionError("fault schedule must not change results")
    if not all(r.status == "ok" for r in faulted):
        raise AssertionError("a request of the faulted run failed")

    hot_swap_demo()
    print("OK")


if __name__ == "__main__":
    main()
