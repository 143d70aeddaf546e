"""Fault-tolerant replicated serving demo: front-door routing over a
replica tier, health-checked failover under injected faults, and a live
reshard — ending in an asserted kill-and-recover run.

    PYTHONPATH=src python examples_torch/serve_replicated.py [--replicas 2]
        [--shards 2] [--scale 0.1] [--device cpu]

Runs on the CUDA card unless ``--device cpu``; with no card it raises.
Every replica, and the single-host oracle, lives on that device.

Walkthrough:
  1. ``build_replica`` stands up P=2 replicas, each a full sharded serving
     stack (own GraphStore + ShardedServeEngine over 2 shards), wired to a
     shared ``FaultInjector`` chaos seam and span tracer;
  2. a ``FrontDoor`` owns global admission and spreads queries across the
     healthy replicas; a steady wave establishes the baseline — zero
     steady-state recompiles, availability 1.0;
  3. transient faults: the injector fails the next extract once, the
     engine retries with exponential backoff and the query still answers;
     a poisoned tenant (100% launch failures) is typed-shed after
     ``max_retries`` without starving anyone else;
  4. KILL: one replica dies mid-wave. The health monitor misses its
     heartbeat, the front door evacuates its in-flight + queued work and
     replays it on the survivor — every accepted query completes, the
     survivor takes zero recompiles, and the batch logs replay bit-exact
     against a single-host oracle;
  5. RECOVER: the replica is revived, passes the recovery hysteresis
     (consecutive good beats) and is re-admitted to the routing set;
  6. live reshard: the survivor's engine is rebuilt P=2 -> P=4 in the
     background from checkpointer artifacts while the old engine keeps
     serving, then atomically swapped in with zero drops.

The demo ASSERTS the invariants as it goes — it is a runnable spec of the
fault-tolerance contract, not just a printout.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch.graphs.datasets import make_dataset
from repro_torch.models import gnn
from repro_torch.serve import (FaultInjector, FrontDoor, GraphStore,
                               HealthPolicy, Resharder, SpanTracer,
                               build_replica)


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on the card "
                           "(pass --device cpu to run it on the CPU)")
    return dev


def replay_bit_exact(engine, single) -> bool:
    """Replay the engine's batch log against the single-host oracle."""
    for batch in engine.batch_log:
        seeds = np.asarray([q.node for q in batch], np.int64)
        want = np.asarray(single.serve_subgraph(seeds))
        for i, q in enumerate(batch):
            if not np.array_equal(np.asarray(q.logits), want[i]):
                return False
    return True


def run(replicas: int = 2, shards: int = 2, queries: int = 64,
        scale: float = 0.1, batch: int = 8, device="cuda",
        params=None) -> dict:
    """The walkthrough; ``params`` replaces the seeded init. Returns the
    tier's figures."""
    args = argparse.Namespace(replicas=replicas, shards=shards,
                              queries=queries, scale=scale, batch=batch)
    dev = _device(device)

    # 1. replica tier ------------------------------------------------------
    d = make_dataset("cora", seed=0, scale=args.scale)
    print(f"graph: cora-like, {d.n_nodes} nodes / {d.n_edges} edges")
    if params is None:
        params = gnn.init_gcn(0, d.x.shape[1], 16, d.n_classes, dev)
    models = {"gcn": ("gcn", params)}
    faults = FaultInjector(seed=0)
    tracer = SpanTracer()
    reps = [build_replica(f"r{i}", d, models, n_shards=args.shards,
                          faults=faults, tracer=tracer,
                          max_batch=args.batch, mode="subgraph",
                          retry_backoff_s=0.001, device=dev)
            for i in range(args.replicas)]
    fd = FrontDoor(reps, faults=faults, tracer=tracer, spread="query",
                   policy=HealthPolicy(deadline_s=0.05))
    t0 = time.perf_counter()
    for r in reps:
        r.engine.warmup("g", "gcn")
    print(f"tier: {args.replicas} replicas x {args.shards} shards "
          f"(warmed in {time.perf_counter()-t0:.1f}s)")

    # oracle for bit-exactness checks
    st = GraphStore(max_batch=args.batch, device=dev)
    st.register_graph("g", d)
    st.register_model("gcn", "gcn", params)
    single = st.session("g", "gcn")

    # 2. steady wave -------------------------------------------------------
    rng = np.random.default_rng(0)
    c0 = sum(r.engine.compile_count for r in reps)
    qs = fd.submit_many("g", "gcn",
                        rng.integers(0, d.n_nodes, size=args.queries))
    fd.run_until_drained(max_ticks=100_000)
    assert all(q.done for q in qs if not q.rejected)
    assert sum(r.engine.compile_count for r in reps) == c0
    print(f"  steady: {fd.metrics.queries} answered @ "
          f"{fd.metrics.qps:.1f} QPS | steady-state recompiles 0")
    steady_qps = fd.metrics.qps

    # 3. transient fault + retry; poisoned tenant typed-shed ---------------
    faults.fail_next("extract", n=1)
    q = fd.submit("g", "gcn", 0)
    try:
        fd.tick()                      # the injected fault fires here
    except Exception:
        pass                           # replica absorbs it via requeue
    fd.run_until_drained(max_ticks=100_000)
    requeues = sum(r.engine.metrics.requeues for r in reps)
    assert q.done and requeues >= 1
    print(f"  transient extract fault: retried and answered "
          f"(requeues={requeues})")

    # a poisoned replica: 100% launch failures scoped to r0. Bounded retry
    # typed-sheds the stuck queries after max_retries instead of wedging
    # the queue; the replica serves again once the fault clears.
    eng = reps[0].engine
    faults.fail("launch", rate=1.0, scope=reps[0].name)
    bad = eng.submit_many("g", "gcn", np.arange(4), tenant="poisoned")
    eng.drain(timeout_s=10.0)          # absorbs the injected failures
    faults.clear()
    eng.resume_intake()
    assert all(b.failed for b in bad)
    assert all(b.failure.reason == "max_retries" for b in bad)
    shed = eng.metrics.retry_shed
    assert shed >= len(bad)
    print(f"  poisoned replica: {shed} queries typed-shed after "
          f"max_retries (stage={bad[0].failure.stage}), healthy again")

    # 4. KILL a replica mid-wave ------------------------------------------
    wave = fd.submit_many("g", "gcn",
                          rng.integers(0, d.n_nodes, size=args.queries))
    for _ in range(3):
        fd.tick()                      # both replicas hold in-flight work
    survivor = reps[0].engine
    cs = survivor.compile_count
    victim = reps[-1].name
    faults.kill(victim)
    print(f"  KILL {victim} mid-wave ({fd.pending} queries outstanding)")
    time.sleep(0.06)                   # let the heartbeat deadline lapse
    fd.run_until_drained(max_ticks=100_000)
    assert all(q.done for q in wave if not q.rejected), "query lost!"
    assert fd.failovers == 1
    assert survivor.compile_count == cs, "survivor recompiled!"
    assert replay_bit_exact(survivor, single), "replay diverged!"
    print(f"  failover: {fd.failover_queries} queries evacuated to the "
          f"survivor, all answered, 0 recompiles, replay bit-exact")

    # 5. RECOVER: revive + hysteresis + re-admission -----------------------
    faults.revive(victim)
    for _ in range(4):                 # recovery_beats good heartbeats
        fd.tick()
    assert fd.health.healthy(victim), "replica not re-admitted!"
    post = fd.submit_many("g", "gcn",
                          rng.integers(0, d.n_nodes, size=args.queries))
    fd.run_until_drained(max_ticks=100_000)
    assert all(q.done for q in post if not q.rejected)
    served = {q.replica for q in post if q.done}
    assert len(served) == args.replicas, "revived replica not serving!"
    print(f"  recovery: {victim} re-admitted after hysteresis "
          f"(readmissions={fd.readmissions}), both replicas serving again")

    # 6. live reshard P -> 2P under load -----------------------------------
    with tempfile.TemporaryDirectory() as artifacts:
        mid = fd.submit_many("g", "gcn",
                             rng.integers(0, d.n_nodes, size=args.queries))
        for _ in range(2):
            fd.tick()                  # queries in flight across the swap
        rs = Resharder(reps[0], "g", "gcn", 2 * args.shards,
                       artifact_dir=artifacts, tracer=tracer)
        rs.prepare(block=False)        # P' builds in the background ...
        # an idle tick holds the GIL for the whole default switch interval
        # (5 ms) each time the build thread wants it back after a torch op;
        # a shorter interval while the loop spins lets the build run
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-4)
        try:
            while not rs.ready:
                fd.tick()              # ... while the old engine serves
        finally:
            sys.setswitchinterval(interval)
        report = rs.swap()
        fd.run_until_drained(max_ticks=100_000)
        assert report.drain.shed == 0, "reshard dropped queries!"
        assert reps[0].engine.n_shards == 2 * args.shards
        assert all(q.done for q in mid if not q.rejected)
        assert replay_bit_exact(reps[0].engine, single)
        print(f"  reshard: P={report.from_shards} -> P={report.to_shards} "
              f"(prepare {report.prepare_s:.1f}s in background, swap "
              f"{report.swap_s*1e3:.0f}ms), 0 drops, replay bit-exact")

    snap = fd.snapshot()
    print(f"tier summary: {snap['metrics']['queries']} answered | "
          f"failovers {snap['failovers']} | readmissions "
          f"{snap['readmissions']} | retry_shed {shed}")
    for r in reps:
        r.engine.close()
    print("all fault-tolerance invariants held")
    return dict(steady_qps=steady_qps, queries=snap["metrics"]["queries"],
                failovers=snap["failovers"],
                readmissions=snap["readmissions"], retry_shed=shed,
                failover_queries=fd.failover_queries,
                reshard_prepare_s=report.prepare_s,
                reshard_swap_s=report.swap_s)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    return run(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
