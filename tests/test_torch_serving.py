"""Port vs reference: the multi-tenant sampling service (`repro_torch.serve`).

Every case of `tests/test_serving.py` runs on the port at ``device="cpu"``
(the kernels' plain versions), the acceptance case in-process on a
logical 2- and 4-band mesh: under a scripted fault schedule — shard
kills, a link flap, a straggler — every admitted request completes and
its spins equal a clean single-device run's bit for bit.  Then the port
is held against `repro.serve` on the same numpy inputs:

* bucket shapes, embeddings, embedded programs and digests are equal;
* one admission sequence with a flap and a straggler forms the same
  launch groups, chain offsets, attempts and health counters (both
  unsharded, in-process);
* one served launch equals the reference's when the reference's launch
  draws and bucket mismatch are carried across (`repro_torch.convert`);
* the bucket spec's backend rule, and ``python -m repro_torch.serve``.
"""
from __future__ import annotations

import json
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as ref_serve
from repro.core import pbit as ref_pbit
from repro.core.chimera import make_chimera as ref_make_chimera
from repro.core.chimera import make_chip_graph as ref_make_chip_graph
from repro.kernels import ref as ref_kernels
from repro_torch import api, convert
from repro_torch import serve as port_serve
from repro_torch.core import pbit as port_pbit
from repro_torch.core.cd import PBitMachine
from repro_torch.core.chimera import make_chimera, make_chip_graph
from repro_torch.core.distributed import make_mesh, surviving_mesh
from repro_torch.core.hardware import HardwareConfig
from repro_torch.kernels import ref as port_kernels
from repro_torch.runtime.fault_tolerance import Heartbeat, TransientError
from repro_torch.serve import (
    AdmissionError,
    CircuitBreaker,
    CircuitOpenError,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    SampleRequest,
    SamplerService,
    ServiceError,
    SessionCache,
    ShardHealthMonitor,
    bucket_shape,
    embed_graph,
    embed_program,
    make_bucket_graph,
    program_digest,
)
from repro_torch.serve.cache import CacheEntry

from _torch_port import leaves

ROOT = Path(__file__).resolve().parent.parent


def _codes(g, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-40, 41, size=g.edges.shape[0], dtype=np.int32),
            rng.integers(-10, 11, size=g.n_nodes, dtype=np.int32))


def _request(g, tenant="t0", chains=2, seed=0, cls=SampleRequest, **kw):
    J, h = _codes(g, seed)
    kw.setdefault("n_sweeps", 4)
    return cls(tenant=tenant, graph=g, J_codes=J, h_codes=h, chains=chains,
               **kw)


def _service(**kw):
    kw.setdefault("capacity_chains", 4)
    kw.setdefault("seed", 0)
    kw.setdefault("device", "cpu")
    return SamplerService(**kw)


# ---------------------------------------------------------------------------
# spec fingerprint (the Session-cache key)
# ---------------------------------------------------------------------------
class TestFingerprint:
    def _spec(self, graph=None, seed=0, sparse=True, **kw):
        g = graph if graph is not None else make_chimera(1, 1)
        m = PBitMachine.create(g, seed, HardwareConfig(), sparse=sparse,
                               noise="counter", device="cpu")
        kw.setdefault("backend", "sparse")
        return api.SamplerSpec(graph=g, hw=m.hw, mismatch=m.mismatch,
                               noise="counter", chains=4, device="cpu", **kw)

    def test_equal_specs_share_fingerprint(self):
        assert self._spec().fingerprint() == self._spec().fingerprint()
        assert api.spec_fingerprint(self._spec()) == \
            api.spec_fingerprint(self._spec())

    def test_fingerprint_discriminates(self):
        base = api.spec_fingerprint(self._spec())
        assert api.spec_fingerprint(
            self._spec(graph=make_chimera(2, 2))) != base
        assert api.spec_fingerprint(self._spec().replace(chains=8)) != base
        assert api.spec_fingerprint(self._spec().replace(beta=2.0)) != base
        assert api.spec_fingerprint(
            self._spec().replace(noise="lfsr")) != base

    def test_fingerprint_canonicalizes_backend_resolution(self, monkeypatch):
        """auto and the name it resolves to must share an entry."""
        monkeypatch.delenv("REPRO_PBIT_BACKEND", raising=False)
        spec = self._spec()
        resolved = api.resolve_backend(spec.replace(backend="auto"))
        assert api.spec_fingerprint(spec.replace(backend="auto")) == \
            api.spec_fingerprint(spec.replace(backend=resolved))

    def test_fingerprint_is_shape_bucket_key(self):
        """Programs and mismatch draws are runtime operands of the
        Session, so two chip instances of one SKU share a cache entry;
        only the mismatch *structure* (dense vs sparse — a different
        programming route) may discriminate."""
        sa, sb = self._spec(seed=0), self._spec(seed=1)
        assert api.spec_fingerprint(sa) == api.spec_fingerprint(sb)
        sd = self._spec(sparse=False, attach_sparse=True)
        assert api.spec_fingerprint(sd) != api.spec_fingerprint(sa)

    def test_digest_is_the_sha1_of_the_fingerprint(self):
        import hashlib
        spec = self._spec()
        assert api.spec_fingerprint(spec) == hashlib.sha1(
            repr(spec.fingerprint()).encode()).hexdigest()[:16]
        assert "spec_fingerprint" in api.__all__


# ---------------------------------------------------------------------------
# shape buckets + embedding
# ---------------------------------------------------------------------------
class TestEmbedding:
    def test_bucket_ladder(self):
        assert bucket_shape(make_chimera(1, 1)) == (1, 1)
        assert bucket_shape(make_chimera(2, 1)) == (2, 2)
        assert bucket_shape(make_chimera(3, 4)) == (4, 4)
        assert bucket_shape(make_chimera(7, 8)) == (7, 8)
        assert bucket_shape(make_chimera(9, 9)) == (9, 9)

    def test_embedding_structure(self):
        g = make_chimera(1, 2)
        bucket = make_bucket_graph(2, 2)
        emb = embed_graph(g, bucket)
        assert emb.node_map.shape == (g.n_nodes,)
        assert len(np.unique(emb.node_map)) == g.n_nodes
        be = np.sort(np.asarray(bucket.edges)[emb.edge_map], axis=1)
        ge = np.sort(emb.node_map[np.asarray(g.edges)], axis=1)
        np.testing.assert_array_equal(be, ge)
        np.testing.assert_array_equal(bucket.node_r[emb.node_map], g.node_r)
        np.testing.assert_array_equal(bucket.node_k[emb.node_map], g.node_k)

    def test_embed_program_zeroes_outside_region(self):
        g = make_chimera(1, 1)
        emb = embed_graph(g, make_bucket_graph(2, 2))
        J = np.arange(1, g.edges.shape[0] + 1, dtype=np.int32)
        h = np.arange(1, g.n_nodes + 1, dtype=np.int32)
        Jb, hb = embed_program(emb, J, h)
        np.testing.assert_array_equal(Jb[emb.edge_map], J)
        np.testing.assert_array_equal(hb[emb.node_map], h)
        out_e = np.setdiff1d(np.arange(Jb.shape[0]), emb.edge_map)
        out_n = np.setdiff1d(np.arange(hb.shape[0]), emb.node_map)
        assert (Jb[out_e] == 0).all() and (hb[out_n] == 0).all()

    def test_embedding_rejects_misfits(self):
        with pytest.raises(ValueError, match="does not fit"):
            embed_graph(make_chimera(3, 3), make_bucket_graph(2, 2))
        with pytest.raises(ValueError, match="k="):
            embed_graph(make_chimera(1, 1, k=2), make_bucket_graph(1, 1))

    def test_masked_graph_embeds(self):
        g = make_chimera(2, 2, masked_cells=((1, 1),))
        emb = embed_graph(g, make_bucket_graph(2, 2))
        assert emb.node_map.shape == (g.n_nodes,)


# the graphs both packages embed: 1x1, 2x2, 4x4, the 440-spin chip into
# 7x8, and a masked non-square graph
EMBED_CASES = [
    ("1x1", lambda mk: mk(1, 1)),
    ("2x2", lambda mk: mk(2, 2)),
    ("4x4", lambda mk: mk(4, 4)),
    ("chip", None),
    ("masked_3x2", lambda mk: mk(3, 2, masked_cells=((0, 1), (2, 0)))),
]


@pytest.mark.parametrize("name,build", EMBED_CASES,
                         ids=[c[0] for c in EMBED_CASES])
def test_embeddings_and_digests_equal_the_reference(name, build):
    pg = make_chip_graph() if build is None else build(make_chimera)
    rg = ref_make_chip_graph() if build is None else build(ref_make_chimera)
    bshape = bucket_shape(pg)
    assert bshape == ref_serve.bucket_shape(rg)
    emb = embed_graph(pg, make_bucket_graph(*bshape))
    ref = ref_serve.embed_graph(rg, ref_serve.make_bucket_graph(*bshape))
    np.testing.assert_array_equal(emb.node_map, ref.node_map)
    np.testing.assert_array_equal(emb.edge_map, ref.edge_map)
    J, h = _codes(pg, 5)
    Jb, hb = embed_program(emb, J, h)
    rJ, rh = ref_serve.embed_program(ref, J, h)
    np.testing.assert_array_equal(Jb, rJ)
    np.testing.assert_array_equal(hb, rh)
    betas = np.linspace(0.2, 1.5, 6, dtype=np.float32)
    mask = np.arange(hb.shape[0]) % 3 == 0
    for cm in (None, mask):
        assert program_digest(bshape, Jb, hb, betas, cm) == \
            ref_serve.program_digest(bshape, rJ, rh, betas, cm)


# ---------------------------------------------------------------------------
# LRU session cache
# ---------------------------------------------------------------------------
class TestSessionCache:
    def _entry(self, meshed=False):
        return CacheEntry(session=None, spec=None, embeddable=None,
                          meshed=meshed, build_s=0.01)

    def test_lru_eviction_and_counters(self):
        c = SessionCache(capacity=2)
        c.get_or_build("a", self._entry)
        c.get_or_build("b", self._entry)
        assert c.get("a") is not None          # refresh a
        c.get_or_build("c", self._entry)       # evicts b (LRU)
        assert c.get("b") is None
        assert c.get("a") is not None and c.get("c") is not None
        s = c.stats()
        assert s["evictions"] == 1 and s["misses"] == 3
        assert s["size"] == 2

    def test_invalidate_predicate(self):
        c = SessionCache(capacity=4)
        c.get_or_build("m", lambda: self._entry(meshed=True))
        c.get_or_build("s", lambda: self._entry(meshed=False))
        assert c.invalidate(lambda fp, e: e.meshed) == 1
        assert c.get("m") is None and c.get("s") is not None


# ---------------------------------------------------------------------------
# fault plans
# ---------------------------------------------------------------------------
class TestFaultPlan:
    def test_json_round_trip(self):
        plan = FaultPlan.make([
            FaultEvent(step=3, kind="kill_shard", shard=1),
            FaultEvent(step=1, kind="link_flap", flaps=2),
            FaultEvent(step=2, kind="straggler", delay_s=0.05),
        ])
        again = FaultPlan.from_json(plan.to_json())
        assert again == plan
        assert [e.step for e in again.events] == [1, 2, 3]  # sorted
        assert again.events_at(3)[0].shard == 1
        # the same JSON as the reference's plan
        assert plan.to_json() == ref_serve.FaultPlan.from_json(
            plan.to_json()).to_json()

    def test_validation(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultEvent(step=0, kind="meteor")
        with pytest.raises(ValueError, match="shard"):
            FaultEvent(step=0, kind="kill_shard")
        with pytest.raises(ValueError, match="list"):
            FaultPlan.from_json("{}")

    def test_injector_sequencing(self):
        class StubService:
            monitor = ShardHealthMonitor()

        svc = StubService()
        inj = FaultInjector(FaultPlan.make([
            FaultEvent(step=1, kind="link_flap", flaps=2),
            FaultEvent(step=2, kind="straggler", delay_s=0.5),
            FaultEvent(step=3, kind="kill_shard", shard=7),
        ]))
        assert inj.on_launch(0, svc) == 0.0
        with pytest.raises(TransientError):
            inj.on_launch(1, svc)
        with pytest.raises(TransientError):
            inj.on_launch(1, svc)
        assert inj.on_launch(1, svc) == 0.0
        assert inj.on_launch(2, svc) == 0.5
        assert inj.on_launch(2, svc) == 0.0     # events fire once
        inj.on_launch(3, svc)
        assert 7 in svc.monitor.dead_shards()
        assert [k for _, k in inj.log] == ["link_flap", "straggler",
                                           "kill_shard"]


# ---------------------------------------------------------------------------
# degradation planning
# ---------------------------------------------------------------------------
class TestDegradePlanning:
    def test_surviving_mesh_single_survivor_is_none(self):
        mesh = make_mesh((1,), ("data",))
        assert surviving_mesh(mesh, dead_ids=()) is None  # 1 survivor
        with pytest.raises(RuntimeError, match="no devices survive"):
            surviving_mesh(mesh, dead_ids=[0])
        four = surviving_mesh(make_mesh((4,), ("rows",)), dead_ids=[1, 3])
        assert four.axis_names == ("rows",) and four.shape == {"rows": 2}
        assert [int(d) for d in four.devices] == [0, 2]

    def test_monitor_unions_marks_and_heartbeats(self, tmp_path):
        mon = ShardHealthMonitor(heartbeat_dir=str(tmp_path), timeout_s=5.0,
                                 time_fn=lambda: 100.0)
        Heartbeat(tmp_path, host_id=0).path.write_text(
            json.dumps({"step": 1, "t": 99.0}))   # fresh
        Heartbeat(tmp_path, host_id=1).path.write_text(
            json.dumps({"step": 1, "t": 10.0}))   # stale
        mon.mark_dead(2)
        assert mon.dead_shards() == frozenset({1, 2})
        mon.mark_alive(2)
        assert mon.dead_shards() == frozenset({1})


# ---------------------------------------------------------------------------
# the service, single device
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def g11():
    return make_chimera(1, 1)


def _replay(spec, req, res, capacity, clamps=(None, None)):
    """A result rebuilt from its metadata: the launch seed, the chain
    offset and the bucket spec."""
    sess = api.Session(spec)
    emb = embed_graph(req.graph, spec.graph)
    Jb, hb = embed_program(emb, req.J_codes, req.h_codes)
    gen = sess.generator(res.launch_key)
    m0, ns = sess.random_spins(gen), sess.noise_state(gen)
    prog = sess.make_program(Jb, hb, clamp_mask=clamps[0],
                             clamp_values=clamps[1])
    betas = np.full((req.n_sweeps,), req.beta, np.float32)
    m, _, _ = sess.sample_program(prog, m0, ns, betas)
    assert m.shape == (capacity, spec.graph.n_nodes)
    off = res.chain_offset
    return m.numpy()[off:off + req.chains][:, emb.node_map]


class TestServiceCore:
    def test_result_is_replayable_from_metadata(self, g11):
        """The full determinism contract in one assertion: a result's
        (launch_key, chain_offset, bucket spec) metadata is a complete
        recipe — a hand-built Session reproduces the service's spins bit
        for bit."""
        svc = _service()
        req = _request(g11, chains=2, seed=3)
        ticket = svc.submit(req)
        svc.drain()
        res = ticket.result()
        assert res.status == "ok"
        assert res.spins.shape == (2, g11.n_nodes)
        np.testing.assert_array_equal(
            res.spins, _replay(svc.bucket_spec(g11), req, res,
                               svc.capacity_chains))

    def test_batching_multiplexes_one_launch(self, g11):
        svc = _service(capacity_chains=8)
        a = svc.submit(_request(g11, tenant="a", chains=2, seed=5))
        b = svc.submit(_request(g11, tenant="b", chains=3, seed=5))
        c = svc.submit(_request(g11, tenant="c", chains=2, seed=6))
        svc.drain()
        ra, rb, rc = a.result(), b.result(), c.result()
        assert ra.launch_seq == rb.launch_seq
        assert (ra.chain_offset, rb.chain_offset) == (0, 2)
        assert rc.launch_seq != ra.launch_seq
        assert svc.metrics["launches"] == 2
        assert svc.cache.stats()["misses"] == 1
        assert svc.cache.stats()["hits"] >= 1

    def test_batch_respects_capacity(self, g11):
        svc = _service(capacity_chains=4)
        t = [svc.submit(_request(g11, tenant=f"t{i}", chains=3, seed=9))
             for i in range(2)]
        svc.drain()
        assert t[0].result().launch_seq != t[1].result().launch_seq

    def test_clamp_values_are_the_tenant_axis(self, g11):
        """Two tenants share one chip + clamp mask but clamp different
        per-chain data; each gets its own data back at the clamped
        nodes."""
        svc = _service(capacity_chains=8)
        mask = np.zeros(g11.n_nodes, bool)
        mask[:2] = True
        va = np.ones((2, g11.n_nodes), np.float32)
        vb = -np.ones((2, g11.n_nodes), np.float32)
        a = svc.submit(_request(g11, tenant="a", chains=2, seed=5,
                                clamp_mask=mask, clamp_values=va))
        b = svc.submit(_request(g11, tenant="b", chains=2, seed=5,
                                clamp_mask=mask, clamp_values=vb))
        svc.drain()
        ra, rb = a.result(), b.result()
        assert ra.launch_seq == rb.launch_seq
        np.testing.assert_array_equal(ra.spins[:, :2], va[:, :2])
        np.testing.assert_array_equal(rb.spins[:, :2], vb[:, :2])

    def test_backpressure(self, g11):
        svc = _service(max_queue=2)
        svc.submit(_request(g11, seed=1))
        svc.submit(_request(g11, seed=2))
        with pytest.raises(AdmissionError, match="backpressure"):
            svc.submit(_request(g11, seed=3))
        assert not svc.readyz()
        assert svc.healthz()["metrics"]["rejected_backpressure"] == 1
        svc.drain()
        assert svc.readyz()

    def test_submit_validates_shapes(self, g11):
        svc = _service()
        bad = _request(g11)
        bad.J_codes = np.zeros(3, np.int32)
        with pytest.raises(ValueError, match="J_codes"):
            svc.submit(bad)
        with pytest.raises(ValueError, match="chains"):
            svc.submit(_request(g11, chains=99))
        with pytest.raises(ServiceError, match="pump"):
            svc.submit(_request(g11)).result()

    def test_deadline_expires_in_queue(self, g11):
        now = [0.0]
        svc = _service(clock=lambda: now[0], sleep=lambda s: None)
        t = svc.submit(_request(g11, timeout_s=5.0))
        now[0] = 10.0
        svc.pump()
        res = t.result()
        assert res.status == "deadline_exceeded"
        assert res.spins is None
        assert svc.metrics["deadline_expired_queued"] == 1

    def test_breaker_opens_and_half_opens(self, g11):
        now = [0.0]
        svc = _service(clock=lambda: now[0], sleep=lambda s: None,
                       breaker=CircuitBreaker(threshold=2, cooldown_s=30.0))
        for _ in range(2):
            svc.submit(_request(g11, tenant="bad", timeout_s=1.0))
            now[0] += 10.0
            svc.pump()
        with pytest.raises(CircuitOpenError):
            svc.submit(_request(g11, tenant="bad"))
        assert svc.healthz()["open_breakers"] == ["bad"]
        ok = svc.submit(_request(g11, tenant="good", timeout_s=1e6))
        svc.drain()
        assert ok.result().status == "ok"
        now[0] += 31.0
        probe = svc.submit(_request(g11, tenant="bad", timeout_s=1e6))
        svc.drain()
        assert probe.result().status == "ok"
        assert svc.breaker.state("bad", now[0]) == "closed"

    def test_link_flap_retries_and_succeeds(self, g11):
        sleeps = []
        svc = _service(
            injector=FaultInjector(FaultPlan.make(
                [FaultEvent(step=0, kind="link_flap", flaps=2)])),
            monitor=ShardHealthMonitor(),
            sleep=sleeps.append, backoff_s=0.01, max_backoff_s=0.5,
            rng=random.Random(0))
        t = svc.submit(_request(g11))
        svc.drain()
        res = t.result()
        assert res.status == "ok" and res.attempts == 3
        assert svc.metrics["transient_retries"] == 2
        assert len(sleeps) == 2 and all(0.01 <= s <= 0.5 for s in sleeps)

    def test_straggler_is_flagged(self, g11):
        now = [0.0]

        def sleep(s):
            now[0] += s

        svc = _service(
            injector=FaultInjector(FaultPlan.make(
                [FaultEvent(step=6, kind="straggler", delay_s=50.0)])),
            monitor=ShardHealthMonitor(), clock=lambda: now[0], sleep=sleep,
            default_timeout_s=1e9)
        tickets = [svc.submit(_request(g11, seed=i)) for i in range(8)]
        for t in tickets:
            now[0] += 0.1
            svc.pump()
        assert all(t.result().status == "ok" for t in tickets)
        flagged = [t.result() for t in tickets
                   if t.result().launch_seq == 6]
        assert flagged and svc.metrics["stragglers_flagged"] >= 1
        assert svc.healthz()["stragglers"] >= 1

    def test_cache_eviction_under_pressure(self, g11):
        svc = _service(cache_capacity=1)
        svc.submit(_request(g11, seed=1))
        svc.submit(_request(make_chimera(2, 2), seed=1))
        svc.submit(_request(g11, seed=2))
        svc.drain()
        s = svc.cache.stats()
        assert s["evictions"] >= 1 and s["size"] == 1
        assert s["misses"] >= 3


# ---------------------------------------------------------------------------
# THE acceptance test: a scripted fault schedule on a logical mesh
# ---------------------------------------------------------------------------
def _accept_requests(graphs, n):
    rng = np.random.default_rng(0)
    progs = {}
    for g in graphs:
        progs[g.rows] = (
            rng.integers(-40, 41, size=g.edges.shape[0], dtype=np.int32),
            rng.integers(-10, 11, size=g.n_nodes, dtype=np.int32))
    out = []
    for i in range(n):
        g = graphs[i % 2]
        J, h = progs[g.rows]
        out.append(SampleRequest(
            tenant=f"tenant-{i % 3}", graph=g, J_codes=J, h_codes=h,
            chains=2, n_sweeps=6, timeout_s=600.0))
    return out


def _accept_run(requests, mesh, injector, monitor):
    svc = _service(mismatch_seed=0, mesh=mesh, monitor=monitor,
                   injector=injector, backoff_s=0.01, max_backoff_s=0.1,
                   sleep=lambda s: None)
    tickets = [svc.submit(r) for r in requests]
    svc.drain()
    return svc, [t.result() for t in tickets]


# launches alternate small bucket (even seq) / large bucket (odd seq): the
# kills land on launches of the meshed bucket
ACCEPT_CASES = {
    "2_bands": dict(bands=2, graphs=((1, 1), (2, 2)), n=8, kills={3: 1},
                    state="single", mesh_after=[]),
    "4_bands": dict(bands=4, graphs=((2, 2), (4, 4)), n=12,
                    kills={3: 1, 5: 3}, state="degraded", mesh_after=[0, 2]),
}


@pytest.mark.parametrize("case", sorted(ACCEPT_CASES))
def test_fault_schedule_zero_drops_bit_identical(case):
    """Shard kills + link flap + straggler: every admitted request
    completes (zero drops) and every spin equals the clean single-device
    run bit for bit — in-process, on a logical row-band mesh."""
    c = ACCEPT_CASES[case]
    graphs = tuple(make_chimera(*rc) for rc in c["graphs"])
    requests = _accept_requests(graphs, c["n"])
    svc_b, res_b = _accept_run(requests, None, None, None)
    plan = FaultPlan.make(
        [FaultEvent(step=1, kind="link_flap", flaps=2),
         FaultEvent(step=2, kind="straggler", delay_s=0.05)]
        + [FaultEvent(step=s, kind="kill_shard", shard=d)
           for s, d in c["kills"].items()])
    mesh = make_mesh((c["bands"],), ("rows",))
    svc_a, res_a = _accept_run(requests, mesh, FaultInjector(plan),
                               ShardHealthMonitor())
    for a, b in zip(res_a, res_b):
        assert a.status == b.status == "ok"
        np.testing.assert_array_equal(a.spins, b.spins)
        assert (a.launch_seq, a.chain_offset) == (b.launch_seq,
                                                  b.chain_offset)
    hz = svc_a.healthz()
    m = hz["metrics"]
    assert m["admitted"] == m["completed"] == c["n"]
    assert hz["state"] == c["state"]
    assert hz["dead_shards"] == sorted(c["kills"].values())
    assert hz["mesh_devices"] == c["mesh_after"]
    assert m["degradations"] == len(c["kills"])
    assert m["replays"] >= len(c["kills"])
    assert m["transient_retries"] == 2
    assert m["straggler_delay_injected"] == 1
    assert m["cache_invalidated"] >= 1
    assert sum(r.degraded for r in res_a) >= 1
    # the large bucket really ran meshed before the first kill
    big = [r for r in res_a if r.launch_seq == 1][0]
    assert big.bucket_shape == c["graphs"][1]
    assert big.bucket_fingerprint not in {
        r.bucket_fingerprint for r in res_b}


# ---------------------------------------------------------------------------
# the backend rule
# ---------------------------------------------------------------------------
BACKEND_CASES = [  # (noise, bands or None, the bucket spec's backend)
    ("counter", None, "fused_sparse"),
    ("lfsr", None, "fused_sparse"),
    ("philox", None, "sparse"),
    ("counter", 2, "fused_sparse"),
    ("lfsr", 2, "sparse"),
]


@pytest.mark.parametrize("noise,bands,want", BACKEND_CASES,
                         ids=[f"{n}-{b or 'unsharded'}"
                              for n, b, _ in BACKEND_CASES])
def test_bucket_spec_backend_rule(noise, bands, want):
    """``fused_sparse`` wherever `api.resolve_backend` admits it, else
    ``sparse``, decided from the spec's fields (ROADMAP Queue 3 item
    16)."""
    mesh = None if bands is None else make_mesh((bands,), ("rows",))
    svc = _service(noise=noise, mesh=mesh)
    spec = svc.bucket_spec(make_chimera(2, 2))
    assert spec.backend == want
    assert api.resolve_backend(spec) == want
    assert api.Session(spec).backend == want
    assert (spec.mesh is None) == (bands is None)
    if noise == "counter" and bands:
        # a sync policy the fused kernels cannot run takes the scan
        loose = _service(mesh=mesh, sync=api.Sync(halo_every=3,
                                                  sweeps_per_launch=2))
        assert loose.bucket_spec(make_chimera(2, 2)).backend == "sparse"


@pytest.mark.parametrize("clamped", [False, True])
def test_service_launch_equals_a_sparse_session(clamped):
    """On the CPU a served ``fused_sparse`` launch equals the same launch
    through a ``sparse`` (half-sweep loop) Session bit for bit."""
    g = make_chimera(2, 2)
    svc = _service(capacity_chains=6)
    kw = {}
    if clamped:
        mask = np.zeros(g.n_nodes, bool)
        mask[::5] = True
        vals = np.where(np.random.default_rng(2).random((3, g.n_nodes))
                        < 0.5, -1.0, 1.0).astype(np.float32)
        kw = dict(clamp_mask=mask, clamp_values=vals)
    reqs = [_request(g, tenant=t, chains=3, seed=4, n_sweeps=10, **kw)
            for t in ("a", "b")]
    tickets = [svc.submit(r) for r in reqs]
    svc.drain()
    spec = svc.bucket_spec(g)
    assert spec.backend == "fused_sparse"
    clamps = (None, None)
    if clamped:
        cv = np.zeros((6, g.n_nodes), np.float32)
        cv[:3], cv[3:] = vals, vals
        clamps = (mask, cv)
    for req, t in zip(reqs, tickets):
        res = t.result()
        assert res.launch_seq == 0
        np.testing.assert_array_equal(
            res.spins, _replay(spec.replace(backend="sparse"), req, res, 6,
                               clamps))


# ---------------------------------------------------------------------------
# against the reference: launch groups, and one launch bit for bit
# ---------------------------------------------------------------------------
def test_admission_sequence_matches_the_reference():
    """The same requests under a flap and a straggler (unsharded, virtual
    clocks, seeded backoff): the same launch groups, chain offsets,
    attempts and health counters as `repro.serve`."""
    plan = [dict(step=1, kind="link_flap", flaps=2),
            dict(step=2, kind="straggler", delay_s=50.0)]
    out = {}
    for name, pkg, mk, extra in (
            ("port", port_serve, make_chimera, {"device": "cpu"}),
            ("ref", ref_serve, ref_make_chimera, {})):
        now = [0.0]

        def sleep(s, now=now):
            now[0] += s

        svc = pkg.SamplerService(
            seed=0, capacity_chains=4, clock=lambda now=now: now[0],
            sleep=sleep, rng=random.Random(0), backoff_s=0.01,
            max_backoff_s=0.1, default_timeout_s=1e9,
            monitor=pkg.ShardHealthMonitor(),
            injector=pkg.FaultInjector(pkg.FaultPlan.make(
                pkg.FaultEvent(**e) for e in plan)),
            watchdog=None, **extra)
        g1, g2 = mk(1, 1), mk(2, 2)
        tickets = []
        for i in range(7):
            g = g1 if i % 3 else g2
            tickets.append(svc.submit(_request(
                g, tenant=f"t{i % 2}", chains=1 + i % 3, seed=i % 2,
                cls=pkg.SampleRequest)))
        while svc.pump():
            now[0] += 0.1
        hz = svc.healthz()
        out[name] = (
            [(r.status, r.launch_seq, r.chain_offset, r.attempts,
              r.bucket_shape) for r in (t.result() for t in tickets)],
            {k: hz[k] for k in ("state", "dead_shards", "queue_depth",
                                "open_breakers", "cache", "stragglers",
                                "metrics")})
    assert out["port"] == out["ref"]
    assert out["port"][1]["metrics"]["transient_retries"] == 2


def _served_requests(pkg, graph, capacity, clamped):
    """Two tenants' requests on one program (one launch), each clamping
    its own values on one mask when ``clamped``."""
    half = capacity // 2
    rng = np.random.default_rng(7)
    mask = rng.random(graph.n_nodes) < 0.2
    reqs = []
    for t in ("a", "b"):
        kw = {}
        if clamped:
            kw = dict(clamp_mask=mask, clamp_values=np.where(
                rng.random((half, graph.n_nodes)) < 0.5, -1.0,
                1.0).astype(np.float32))
        reqs.append(_request(graph, tenant=t, chains=half, seed=3,
                             n_sweeps=8, beta=1.5, cls=pkg.SampleRequest,
                             **kw))
    return reqs


def _served(svc, reqs):
    tickets = [svc.submit(r) for r in reqs]
    svc.drain()
    return [t.result() for t in tickets]


def _decision_margins(ref_chip, port_chip, color, m0, ns, betas, cm, cv):
    """Step-locked half-sweeps of one launch (ROADMAP Queue 3 item 3):
    from the reference's spins, both packages' decisions agree to 1e-6 and
    their spins wherever |decision| > 1e-5; returns the smallest
    |decision| of an updated node and the walk's final spins."""
    B, N = m0.shape
    ref_step = ref_pbit.make_counter_noise(B, N)[1]
    port_step = port_pbit.make_counter_noise(B, N, device="cpu")[1]
    st_r = jnp.asarray(ns)
    st_p = convert.noise_state_from_numpy(ns, "cpu")
    cm = np.zeros(N, bool) if cm is None else cm
    masks = [(color == c) & ~cm for c in (0, 1)]
    m = m0
    low = np.inf
    for beta in betas:
        if cv is not None:
            m = np.where(cm, cv, m)
        for mk in masks:
            st_r, u_r = ref_step(st_r)
            st_p, u_p = port_step(st_p)
            I_r = ref_kernels.sparse_neuron_input(
                jnp.asarray(m), ref_chip.nbr_idx, ref_chip.nbr_w, ref_chip.h)
            d_r = np.asarray(
                jnp.tanh(beta * ref_chip.tanh_gain
                         * (I_r + ref_chip.tanh_offset))
                + ref_chip.rand_gain * u_r + ref_chip.comp_offset)
            I_p = port_kernels.sparse_neuron_input(
                torch.from_numpy(np.array(m)), port_chip.nbr_idx,
                port_chip.nbr_w, port_chip.h)
            d_p = port_kernels.decision_value(
                I_p, port_chip.tanh_gain, port_chip.tanh_offset,
                port_chip.rand_gain, port_chip.comp_offset, float(beta),
                u_p).numpy()
            np.testing.assert_allclose(d_p[:, mk], d_r[:, mk], rtol=0,
                                       atol=1e-6)
            sure = (np.abs(d_r) > 1e-5) & mk
            np.testing.assert_array_equal(d_p[sure] >= 0, d_r[sure] >= 0)
            low = min(low, float(np.abs(d_r[:, mk]).min()))
            m = np.where(mk, np.where(d_r >= 0, 1.0, -1.0), m).astype(
                np.float32)
    return low, m


SERVED_CASES = [("2x2", False), ("2x2", True), ("chip", False),
                ("chip", True)]


@pytest.mark.parametrize("graph,clamped", SERVED_CASES,
                         ids=[f"{g}-{'clamped' if c else 'free'}"
                              for g, c in SERVED_CASES])
def test_served_launch_equals_the_reference(graph, clamped):
    """The reference serves one launch (``sparse``: its scan); its launch
    draws — ``fold_in``, ``split``, ``random_spins``, ``noise_state`` —
    and its bucket mismatch cross to the port service through
    `repro_torch.convert` (its draw method and mismatch cache).  Tolerance
    (ROADMAP Queue 3 item 3): decisions agree to 1e-6 and spins wherever
    |decision| > 1e-5; no decision of these launches lies within 1e-5
    (asserted), so each tenant's spins must be equal."""
    capacity = 8
    rg = ref_make_chip_graph() if graph == "chip" else ref_make_chimera(2, 2)
    pg = make_chip_graph() if graph == "chip" else make_chimera(2, 2)
    ref_svc = ref_serve.SamplerService(seed=0, capacity_chains=capacity)
    ref_res = _served(ref_svc, _served_requests(ref_serve, rg, capacity,
                                                clamped))
    r0 = ref_res[0]
    bshape = r0.bucket_shape
    entry = ref_svc.cache.get(r0.bucket_fingerprint)
    km, kn = jax.random.split(jnp.asarray(r0.launch_key))
    bn = entry.spec.graph.n_nodes
    m0 = np.asarray(ref_pbit.random_spins(km, capacity, bn))
    ns = np.asarray(entry.session.noise_state(kn))

    svc = _service(capacity_chains=capacity)
    svc._bucket_mismatch[bshape] = convert.mismatch_from_numpy(
        leaves(ref_svc._bucket_mismatch[bshape]), "cpu")
    svc._launch_state = lambda session, key: (
        convert.spins_from_numpy(m0, "cpu"),
        convert.noise_state_from_numpy(ns, "cpu"))
    reqs = _served_requests(port_serve, pg, capacity, clamped)
    res = _served(svc, reqs)
    assert svc.bucket_spec(pg).backend == "fused_sparse"
    # the launch's decisions, both packages step-locked
    emb = embed_graph(pg, make_bucket_graph(*bshape))
    Jb, hb = embed_program(emb, reqs[0].J_codes, reqs[0].h_codes)
    cm = cv = None
    if clamped:
        cm = np.zeros(bn, bool)
        cm[emb.node_map] = reqs[0].clamp_mask
        cv = np.zeros((capacity, bn), np.float32)
        cv[:4, emb.node_map] = reqs[0].clamp_values
        cv[4:, emb.node_map] = reqs[1].clamp_values
    low, walked = _decision_margins(
        entry.session.program_edges(jnp.asarray(Jb), jnp.asarray(hb)),
        svc.cache.get(res[0].bucket_fingerprint).session.program_edges(
            Jb, hb),
        np.asarray(entry.spec.graph.color), m0, ns,
        np.full(8, 1.5, np.float32), cm, cv)
    assert low > 1e-5
    for r, p in zip(ref_res, res):
        assert (p.launch_seq, p.chain_offset, p.bucket_shape) == (
            r.launch_seq, r.chain_offset, r.bucket_shape)
        np.testing.assert_array_equal(p.spins, np.asarray(r.spins))
        np.testing.assert_array_equal(
            p.spins, walked[p.chain_offset:p.chain_offset + 4][
                :, emb.node_map])


# ---------------------------------------------------------------------------
# the exports and the demo loop
# ---------------------------------------------------------------------------
def test_exports_equal_the_references():
    assert port_serve.__all__ == ref_serve.__all__
    for name in port_serve.__all__:
        assert hasattr(port_serve, name), name


@pytest.mark.parametrize("faulted", [False, True])
def test_demo_loop_runs_on_the_cpu(faulted, tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.serve", "--device", "cpu",
           "--requests", "4"]
    if faulted:
        plan = tmp_path / "plan.json"
        plan.write_text(FaultPlan.make([
            FaultEvent(step=1, kind="link_flap", flaps=2),
            FaultEvent(step=2, kind="straggler", delay_s=0.01)]).to_json())
        cmd += ["--faultplan", str(plan)]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    health = json.loads(proc.stdout[proc.stdout.index("\n{") + 1:])
    assert health["metrics"]["completed"] == 4
    assert health["metrics"].get("transient_retries", 0) == (
        2 if faulted else 0)
    assert "jax" not in proc.stderr


def test_default_device_without_cuda_raises(tmp_path):
    """The service and its demo loop run on the card unless asked for the
    CPU: without a GPU the default raises, with no CPU fallback."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        SamplerService()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.serve",
                           "--requests", "1"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert "cuda" in proc.stderr and "tenant" not in proc.stdout
