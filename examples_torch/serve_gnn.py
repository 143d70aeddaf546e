"""End-to-end GNN serving demo: register a synthetic Table-2 graph, compile
a tuner-selected session, and answer node-classification queries under load
through the micro-batching engine.

    PYTHONPATH=src python examples_torch/serve_gnn.py [--queries 200] [--scale 0.2]
        [--device cpu] [--trace PATH]

Runs on the CUDA card unless ``--device cpu``; with no card it raises.
The tuner may pick another plan on the card than on the CPU, so served
answers are held against the direct ``*_forward_bitgnn`` under this run's
own plan (step 6).

Walkthrough:
  1. GraphStore registers the graph + a briefly STE-trained binary GCN;
  2. ``store.session(tune=True)`` builds the serving artifact: FRDC
     adjacencies, bit-packed weights, full-graph BN calibration, and the
     variant plan the tuner picked by timing the legal BMM/BSpMM pairings
     on this graph (paper §3.4);
  3. the engine warms the shape buckets, then serves the query stream
     through the micro-batched k-hop subgraph path — the program
     counter verifies ZERO steady-state recompiles;
  4. the same stream through the PIPELINED loop (``pipeline_depth=2``):
     extraction of batch i+1 runs on a background worker while batch i's
     forward is in flight — bit-exact vs the serial loop, with the
     overlap ratio and per-stage breakdown reported;
  5. the same queries through the cached full-graph fast path, plus a
     feature-update to show invalidation;
  6. QPS / p50 / p99 and cache counters are printed for all paths;
  7. multi-tenant admission: a rate-limited "hog" tenant floods the engine
     10x over its quota and is throttled/shed with typed rejections while
     a weighted "gold" tenant keeps serving — per-tenant counters and
     latency come out of the same ``snapshot()``;
  8. observability: every batch left a span tree (queue wait / extract /
     launch / compute) in the engine's trace ring buffer — exported here
     as a Perfetto-loadable Chrome trace and a Prometheus text snapshot,
     with the recompile/transfer watchdog counters alongside;
  9. cost accounting + SLOs: a ``CostEstimator`` predicts each query's cost
     units at submit time (k-hop closure via the CSR index) and an
     ``SLOTracker`` turns rejections/latency into error-budget burn. An
     "ml-batch" tenant floods hub-node whales while staying nominally
     under its QPS quota — the COST budget is what throttles it, its burn
     rate breaches both alert windows (a structured ``slo_burn`` warning
     fires into the span tracer), and the feedback loop shrinks its
     effective queue depth, all while the "gold" tenant keeps serving.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import frdc
from repro_torch.graphs.datasets import make_dataset
from repro_torch.models import gnn
from repro_torch.serve import (AdmissionController, CostEstimator,
                               GNNServeEngine, GraphStore, SLOPolicy,
                               SLOTracker, SpanTracer, TenantPolicy,
                               prometheus_text, write_chrome_trace)


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on the card "
                           "(pass --device cpu to run it on the CPU)")
    return dev


def _report(tag: str, snap: dict) -> None:
    lat = snap["latency"]
    print(f"  [{tag}] {snap['queries']} queries in {snap['elapsed_s']:.2f}s"
          f" -> {snap['qps']:.1f} QPS | p50 {lat['p50_ms']:.2f}ms"
          f" p99 {lat['p99_ms']:.2f}ms | cache hit-rate"
          f" {snap['cache_hit_rate']:.2f} | compiles {snap['compiles']}")


def run(queries: int = 200, scale: float = 0.2, batch: int = 16,
        epochs: int = 30, device="cuda", params=None,
        trace: str = None) -> dict:
    """The walkthrough (steps 1-9); ``params`` replaces the seeded init.
    Returns the key figures of each step."""
    args = argparse.Namespace(queries=queries, scale=scale, batch=batch,
                              epochs=epochs)
    dev = _device(device)
    trace = trace or os.path.join(tempfile.gettempdir(),
                                  "serve_gnn_torch_trace.json")
    out = {}

    # 1. graph + briefly-trained binary GCN ---------------------------------
    d = make_dataset("cora", seed=0, scale=args.scale)
    print(f"graph: cora-like, {d.n_nodes} nodes / {d.n_edges} edges / "
          f"{d.x.shape[1]} features / {d.n_classes} classes")
    if params is None:
        params = gnn.init_gcn(0, d.x.shape[1], 32, d.n_classes, dev)
    if args.epochs:
        adj_dense = frdc.to_dense(d.adjacency("gcn", dev))
        params, loss = gnn.train_node_classifier(
            gnn.gcn_forward_bigcn, params,
            (torch.from_numpy(d.x).to(dev), adj_dense),
            torch.from_numpy(d.y).to(dev),
            torch.from_numpy(d.train_mask).to(dev), epochs=args.epochs)
        print(f"trained Bi-GCN STE for {args.epochs} epochs, loss {loss:.3f}")

    store = GraphStore(max_batch=args.batch, device=dev)
    store.register_graph("cora", d)
    store.register_model("gcn", "gcn", params)

    # 2. compile the session (tuner-selected plan) --------------------------
    t0 = time.perf_counter()
    sess = store.session("cora", "gcn", tune=True)
    print(f"compiled session {sess.key!r} in {time.perf_counter()-t0:.1f}s")
    print(f"  plan: {sess.plan.name()}  "
          f"({sess.plan.tuned_latency_s*1e3:.1f}ms full-graph fwd)")

    # 3. micro-batched subgraph serving, zero steady-state recompiles -------
    engine = GNNServeEngine(store, max_batch=args.batch, mode="subgraph")
    warm = engine.warmup("cora", "gcn")
    print(f"warmup: {warm} programs (shape buckets populated)")
    c0 = engine.compile_count
    rng = np.random.default_rng(1)
    nodes = rng.integers(0, d.n_nodes, size=args.queries)
    for i in range(0, nodes.size, args.batch):   # arrival in waves
        engine.submit_many("cora", "gcn", nodes[i:i + args.batch])
        engine.tick()
    engine.run_until_drained()
    steady = engine.compile_count - c0
    _report("subgraph", engine.snapshot())
    print(f"  steady-state recompiles: {steady}")
    assert steady == 0, "program counter moved in steady state!"
    out["subgraph"] = engine.snapshot()

    # 4. pipelined serving: overlapped extraction, bit-exact ----------------
    # sample_every=1 records every batch's span tree (the default engine
    # tracer keeps 1-in-16 plus outliers and error paths)
    pipe = GNNServeEngine(store, max_batch=args.batch, mode="subgraph",
                          pipeline_depth=2,
                          tracer=SpanTracer(sample_every=1))
    pipe.warmup("cora", "gcn")
    qp = pipe.submit_many("cora", "gcn", nodes)
    pipe.run_until_drained()
    snap = pipe.snapshot()
    bd = snap["batch_breakdown"]
    print(f"  [pipelined d=2] {snap['qps']:.1f} QPS | overlap ratio "
          f"{snap['overlap_ratio']:.2f} | extract p50 "
          f"{bd['extract']['p50_ms']:.2f}ms / compute p50 "
          f"{bd['compute']['p50_ms']:.2f}ms")
    serial_logits = {q.qid: q.logits for q in engine.finished}
    exact = all(np.array_equal(qp[i].logits, serial_logits[i])
                for i in range(len(qp)))
    assert exact, "pipelined loop diverged from the serial loop!"
    print("  pipelined answers are bit-exact vs the serial loop")
    pipe.close()
    out["pipelined"] = snap

    # 5. cached full-graph fast path + invalidation -------------------------
    engine2 = GNNServeEngine(store, max_batch=args.batch, mode="full")
    engine2.submit_many("cora", "gcn", nodes)
    engine2.run_until_drained()
    _report("full-cache", engine2.snapshot())
    out["full_cache"] = engine2.snapshot()

    x2 = d.x.copy()
    x2[: d.n_nodes // 10] = 0.0                  # feature update
    store.update_features("cora", x2)
    q = engine2.submit_many("cora", "gcn", nodes[:8])
    engine2.run_until_drained()
    snap = engine2.snapshot()
    print(f"  feature update -> invalidations {snap['invalidations']}, "
          f"8 queries re-served from the recomputed cache "
          f"(preds: {[qq.pred for qq in q]})")

    # 6. sanity: served == direct forward -----------------------------------
    direct = gnn.gcn_forward_bitgnn(
        sess.qparams, torch.from_numpy(x2).to(dev), sess._adj_full["adj"],
        sess._adj_full["bin"], scheme=sess.plan.scheme,
        trinary_mode=sess.plan.trinary_mode)
    want = np.argmax(direct.cpu().numpy()[[qq.node for qq in q]], axis=-1)
    got = np.asarray([qq.pred for qq in q])
    assert (got == want).all(), "served predictions diverged from direct!"
    print("served predictions match the direct *_forward_bitgnn outputs")

    # 7. multi-tenant admission: quotas, shedding, weighted scheduling -------
    admission = AdmissionController(policies={
        "gold": TenantPolicy(weight=4),
        "hog": TenantPolicy(rate_qps=50.0, burst=args.batch,
                            max_queue_depth=2 * args.batch, weight=1),
    })
    mt = GNNServeEngine(store, max_batch=args.batch, mode="full",
                        admission=admission)
    mt.warmup("cora", "gcn")
    for i in range(0, nodes.size, args.batch):
        # the hog floods 10x its share; rejects come back TYPED (throttle
        # with a retry hint, or shed at the queue-depth bound) — they never
        # raise into the serving tick
        hogged = mt.submit_many("cora", "gcn",
                                rng.integers(0, d.n_nodes, 10 * args.batch),
                                tenant="hog")
        mt.submit_many("cora", "gcn", nodes[i:i + args.batch],
                       tenant="gold")
        mt.tick()
        del hogged
    mt.run_until_drained()
    tsnap = mt.snapshot()["tenants"]
    for name in ("gold", "hog"):
        t = tsnap[name]
        print(f"  [tenant {name}] accepted {t['accepted']} | throttled "
              f"{t['throttled']} | shed {t['shed']} (reject-rate "
              f"{t['reject_rate']:.2f}) | served {t['queries']} @ "
              f"{t['qps']:.1f} QPS | p99 {t['latency']['p99_ms']:.2f}ms")
    assert tsnap["gold"]["queries"] == nodes.size, "gold tenant starved!"
    assert tsnap["hog"]["reject_rate"] > 0, "hog was never limited!"
    print("  gold tenant fully served; hog throttled/shed per policy")
    out["tenants"] = tsnap

    # 8. observability: span traces, watchdogs, exporters --------------------
    trs = pipe.tracer.batch_traces()
    wd = pipe.snapshot()["watchdogs"]
    print(f"  [trace] {len(trs)} batch span trees recorded "
          f"({pipe.tracer.batches_seen} batches seen) | steady recompiles "
          f"{wd['recompile']['steady_recompiles']} | unexpected transfers "
          f"{wd['transfer']['host_sync_in_launch']}")
    t = trs[0]
    print(f"    e.g. trace {t.trace_id}: {len(t.queries)} queries, "
          + ", ".join(f"{s.name} {s.duration_s*1e3:.2f}ms"
                      for s in t.spans))
    write_chrome_trace(pipe.tracer, trace)
    print(f"    Chrome trace -> {trace} "
          "(load in chrome://tracing or ui.perfetto.dev)")
    prom = prometheus_text(pipe.snapshot(), pipe.tracer)
    print("    Prometheus snapshot (first lines):")
    for line in prom.splitlines()[:4]:
        print(f"      {line}")

    # 9. cost accounting + SLOs: budgets, burn alerts, admission feedback ----
    cost = CostEstimator()
    csr = store.graphs["cora"].csr
    degs = np.asarray(csr.indptr[1:]) - np.asarray(csr.indptr[:-1])
    hubs = np.argsort(degs)[-max(32, args.batch):]
    hub_units = float(np.mean([cost.estimate("cora", int(n), csr).units
                               for n in hubs[-8:]]))
    ce = GNNServeEngine(
        store, max_batch=args.batch, mode="subgraph",
        admission=AdmissionController(policies={
            "gold": TenantPolicy(weight=4),
            # the whale tenant's QPS quota is GENEROUS — only its
            # cost-unit budget (~3 hub queries/s) binds
            "ml-batch": TenantPolicy(rate_qps=500.0, burst=500,
                                     max_queue_depth=2 * args.batch,
                                     cost_rate=3.0 * hub_units,
                                     cost_burst=3.0 * hub_units),
        }),
        cost=cost,
        slo=SLOTracker({
            "ml-batch": SLOPolicy(availability=0.99, window_s=4.0,
                                  short_window_s=0.5, burn_alert=2.0),
            "gold": SLOPolicy(availability=0.999, window_s=4.0),
        }))
    ce.warmup("cora", "gcn")
    for i in range(0, nodes.size, args.batch):
        # hub-band whales: nominally under the QPS limit, way over budget
        ce.submit_many("cora", "gcn", rng.choice(hubs, 2 * args.batch),
                       tenant="ml-batch")
        ce.submit_many("cora", "gcn", nodes[i:i + args.batch],
                       tenant="gold")
        ce.tick()
        ce.tick()
        ce.tick()
    ce.run_until_drained()
    csnap = ce.snapshot()
    for name in ("gold", "ml-batch"):
        t = csnap["tenants"][name]
        s = csnap["slo"]["tenants"][name]
        print(f"  [cost {name}] admitted {t['cost_units']:.0f} units | "
              f"cost-throttled {t['cost_throttled']} | attributed "
              f"{t['attributed_cost_s']*1e3:.1f}ms of service | burn "
              f"{s['burn_long']:.1f} | alerts {s['alerts']} | depth-scale "
              f"{s['depth_scale']:.2f}")
    burns = [w for w in ce.tracer.warning_events() if w.name == "slo_burn"]
    assert csnap["tenants"]["ml-batch"]["cost_throttled"] > 0, \
        "whale tenant was never held to its cost budget!"
    assert burns, "no slo_burn alert fired!"
    assert csnap["tenants"]["gold"]["queries"] == nodes.size
    print(f"  whale tenant held to cost budget ({len(burns)} burn alert(s) "
          f"fired, depth autotuned "
          f"x{csnap['slo']['tenants']['ml-batch']['depth_scale']:.2f}); "
          f"gold tenant fully served")
    print(f"  calibration: {csnap['cost']['batches_observed']} batches, "
          f"units/s {csnap['cost']['units_per_second']:.0f}")
    out["cost"] = csnap
    out["plan"] = sess.plan.name()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="Chrome trace path (default: serve_gnn_torch_"
                         "trace.json in the temp directory)")
    return run(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
