"""Sharded GNN serving demo: partition a graph across P shards and answer
node queries with cross-shard k-hop routing + halo exchange.

    PYTHONPATH=src python examples_torch/serve_sharded.py [--shards 4] [--scale 0.2]
        [--device cpu] [--trace PATH]

Runs on the CUDA card unless ``--device cpu``; with no card it raises.

Walkthrough:
  1. a GraphStore registers a synthetic Table-2 graph + a binary GCN;
  2. ``store.sharded_session(graph, model, P)`` runs the ShardPlanner
     (edge-balanced tile-row cuts via graphs/partition.py), builds per-shard
     intra FRDC + bit-packed halo adjacencies and a routing table, compiles
     one bucketed serve core per shard and calibrates BN once;
  3. the distributed full pass fills the per-shard logits caches, exchanging
     activations layer-wise — PACKED words on the binary-aggregation layer;
  4. the ShardedServeEngine routes micro-batched queries to their owning
     shards (per-owner queues with HALO-AWARE batch formation: seeds whose
     closures request the same halo tiles are co-batched under a staleness
     bound) and serves them with ZERO steady-state recompiles per shard;
     answers are bit-exact vs single-host serving. A second pass runs the
     PIPELINED loop (extraction overlapped with the in-flight forward) and
     reports the overlap ratio + estimated halo bytes saved;
  5. inside a world of P ranks, the SPMD layer executor re-runs the full
     pass one shard a rank (the halo exchange over ``torch.distributed``)
     — bit-identical to the host-orchestrated pass — and the distributed
     BN calibration (all-gathered moments, no single-host anchor pass) is
     compared to it;
  6. artifacts (per-shard FRDC + routing.json, incl. the ``spmd`` plan)
     roundtrip through the checkpointer without re-partitioning;
  7. multi-tenant serving: two tenants with 4:1 scheduler weights share the
     sharded engine — queues are keyed by (owner, tenant), so batches stay
     single-owner AND single-tenant (the bit-exactness invariant survives
     tenancy) and ``snapshot()`` breaks QPS/latency out per tenant;
  8. observability: the pipelined run records a span tree per batch
     (queue wait / extract / launch / compute, tagged with the owning
     shard, halo bytes moved and formation savings) — exported as a
     Chrome trace with one track per shard, watchdog counters alongside.

In one process ``make_shard_mesh`` returns None, so the halo exchange
runs as a host loopback and step 5 is skipped, as the JAX example skips it
on one device. ``chip_smoke.py`` phase 18 runs the SPMD pass on the card
(four gloo ranks restoring the sharded artifacts).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.graphs.datasets import make_dataset
from repro_torch.launch.mesh import make_shard_mesh
from repro_torch.models import gnn
from repro_torch.serve import (AdmissionController, GraphStore,
                               ShardedServeEngine, SpanTracer, TenantPolicy,
                               write_chrome_trace)


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on the card "
                           "(pass --device cpu to run it on the CPU)")
    return dev


def run(shards: int = 4, queries: int = 200, scale: float = 0.2,
        batch: int = 16, device="cuda", params=None,
        trace: str = None) -> dict:
    """The walkthrough; ``params`` replaces the seeded init. Returns the
    key figures of each step."""
    args = argparse.Namespace(shards=shards, queries=queries, scale=scale,
                              batch=batch)
    dev = _device(device)
    trace = trace or os.path.join(tempfile.gettempdir(),
                                  "serve_sharded_torch_trace.json")
    out = {}

    # 1. graph + model -------------------------------------------------------
    d = make_dataset("cora", seed=0, scale=args.scale)
    print(f"graph: cora-like, {d.n_nodes} nodes / {d.n_edges} edges")
    if params is None:
        params = gnn.init_gcn(0, d.x.shape[1], 32, d.n_classes, dev)
    with tempfile.TemporaryDirectory() as cache:
        store = GraphStore(cache_dir=cache, max_batch=args.batch,
                           device=dev)
        store.register_graph("cora", d)
        store.register_model("gcn", "gcn", params)

        # 2. plan + compile the sharded session -----------------------------
        mesh = make_shard_mesh(args.shards)
        ranks = (torch.distributed.get_world_size()
                 if torch.distributed.is_initialized() else 1)
        print(f"halo transport: "
              f"{'mesh collectives' if mesh is not None else 'host loopback'}"
              f" ({ranks} ranks)")
        t0 = time.perf_counter()
        sess = store.sharded_session("cora", "gcn", args.shards, mesh=mesh)
        stats = sess.shard_plan.stats()
        print(f"planned + compiled {sess.key!r} in "
              f"{time.perf_counter()-t0:.1f}s")
        print(f"  local nodes per shard: {stats['local_nodes']}, halo "
              f"nodes: {stats['halo_nodes']}, edge-cut "
              f"{stats['edge_cut_fraction']:.1%}, imbalance "
              f"{stats['imbalance']:.2f}")
        out["plan_stats"] = stats

        # 3. distributed full pass already ran in sync(): halo per layer ----
        for tag, b in sorted(sess.halo_stats.bytes_by_tag.items()):
            print(f"  halo[{tag}]: {b} bytes")
        out["halo_bytes_by_tag"] = dict(sess.halo_stats.bytes_by_tag)

        # 4. routed micro-batched serving -----------------------------------
        engine = ShardedServeEngine(store, args.shards, max_batch=args.batch,
                                    mode="subgraph", mesh=mesh)
        warm = engine.warmup("cora", "gcn")
        c0 = engine.compile_count
        rng = np.random.default_rng(1)
        nodes = rng.integers(0, d.n_nodes, size=args.queries)
        for i in range(0, nodes.size, args.batch):
            engine.submit_many("cora", "gcn", nodes[i:i + args.batch])
            engine.tick()
        engine.run_until_drained()
        snap = engine.snapshot()
        lat = snap["latency"]
        print(f"  warmup compiles {warm} | steady-state recompiles "
              f"{engine.compile_count - c0} (per shard: "
              f"{snap['compiles_by_shard']})")
        print(f"  {snap['queries']} queries -> {snap['qps']:.1f} QPS | "
              f"p50 {lat['p50_ms']:.2f}ms p99 {lat['p99_ms']:.2f}ms | "
              f"serve halo {snap['halo_bytes_by_tag'].get('serve/x', 0)} B")
        assert engine.compile_count == c0, "steady-state recompile!"
        out["routed"] = snap

        # 4b. pipelined + halo-aware: overlap + halo sharing ----------------
        pipe = ShardedServeEngine(store, args.shards, max_batch=args.batch,
                                  mode="subgraph", mesh=mesh,
                                  pipeline_depth=2,
                                  tracer=SpanTracer(sample_every=1))
        pipe.warmup("cora", "gcn")
        pipe.submit_many("cora", "gcn", nodes)
        pipe.run_until_drained()
        ps = pipe.snapshot()
        print(f"  [pipelined d=2] {ps['qps']:.1f} QPS | overlap "
              f"{ps['overlap_ratio']:.2f} | halo tiles co-batched "
              f"{ps['halo_tiles_shared']} (~{ps['halo_bytes_saved']} B of "
              f"serve/x gathers deduplicated)")
        pipe.close()
        out["pipelined"] = ps

        # 8. observability: per-shard span traces + watchdogs ---------------
        trs = pipe.tracer.batch_traces()
        wd = ps["watchdogs"]
        print(f"  [trace] {len(trs)} batch span trees across shards "
              f"{sorted({t.shard for t in trs})} | steady recompiles "
              f"{wd['recompile']['steady_recompiles']} | unexpected "
              f"transfers {wd['transfer']['host_sync_in_launch']}")
        t = trs[0]
        print(f"    e.g. trace {t.trace_id} (shard {t.shard}): "
              f"extract {t.stage_s('extract')*1e3:.2f}ms / compute "
              f"{t.stage_s('compute')*1e3:.2f}ms | halo {t.halo}")
        write_chrome_trace(pipe.tracer, trace)
        print(f"    Chrome trace (one track per shard) -> {trace}")

        # 5. SPMD executor + distributed BN calibration ---------------------
        if mesh is not None:
            spmd = store.sharded_session("cora", "gcn", args.shards,
                                         executor="spmd")
            spmd.run_distributed_pass()        # warm: compile the programs
            sess.run_distributed_pass()
            t0 = time.perf_counter()
            spmd.run_distributed_pass()
            dt_spmd = time.perf_counter() - t0
            t0 = time.perf_counter()
            sess.run_distributed_pass()
            dt_host = time.perf_counter() - t0
            exact = np.array_equal(spmd.full_logits(), sess.full_logits())
            print(f"SPMD executor: full pass {dt_spmd*1e3:.1f}ms vs host "
                  f"{dt_host*1e3:.1f}ms | bit-exact={exact} | "
                  f"{spmd.executor_compile_count} compiles for "
                  f"{len(spmd.program)} layer programs")
            dist = store.sharded_session("cora", "gcn", args.shards,
                                         executor="spmd",
                                         bn_mode="distributed")
            da, aa = dist.full_logits(), sess.full_logits()
            print(f"distributed BN calibration: max|logit delta| "
                  f"{np.abs(da-aa).max():.2e}, argmax agreement "
                  f"{(np.argmax(da,-1)==np.argmax(aa,-1)).mean():.2%}")
        else:
            print("(< P ranks: SPMD executor section skipped)")

        # 6. sanity vs single host + artifact restore -----------------------
        single = store.session("cora", "gcn")
        sample = nodes[: args.batch]
        owners = sess.routing.owner(sample)
        for o in np.unique(owners):
            grp = sample[owners == o]
            a = sess.serve_subgraph(grp)
            b = single.serve_subgraph(grp)
            assert np.array_equal(a, b), "sharded != single-host!"
        print("sharded answers are bit-exact vs the single-host session")

        store2 = GraphStore(cache_dir=cache, max_batch=args.batch,
                            device=dev)
        store2.register_graph("cora", d)
        store2.register_model("gcn", "gcn", params)
        restored = store2.sharded_session("cora", "gcn", args.shards)
        assert np.array_equal(restored.routing.bounds, sess.routing.bounds)
        print("artifact restored from cache without re-partitioning")

        # 7. multi-tenant sharded serving ------------------------------------
        admission = AdmissionController(policies={
            "gold": TenantPolicy(weight=4),
            "base": TenantPolicy(weight=1)})
        mt = ShardedServeEngine(store, args.shards, max_batch=args.batch,
                                mode="subgraph", mesh=mesh,
                                admission=admission)
        mt.warmup("cora", "gcn")
        for i, n in enumerate(nodes):
            mt.submit("cora", "gcn", int(n),
                      tenant=("gold" if i % 2 else "base"))
        mt.run_until_drained()
        mixed = sum(len({q.tenant for q in b}) != 1 for b in mt.batch_log)
        assert mixed == 0, "a served batch mixed tenants!"
        for name, t in sorted(mt.snapshot()["tenants"].items()):
            print(f"  [tenant {name}] served {t['queries']} @ "
                  f"{t['qps']:.1f} QPS | p99 {t['latency']['p99_ms']:.2f}ms")
        print("  batches stayed single-owner and single-tenant")
        out["tenants"] = mt.snapshot()["tenants"]
        mt.close()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--scale", type=float, default=0.2)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace", default=None,
                    help="Chrome trace path (default: serve_sharded_torch_"
                         "trace.json in the temp directory)")
    return run(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
