"""Rank functions of ``tests/test_torch_spmd.py`` (and
``tests/test_torch_run_ranks.py``'s spawned world).

``launch.mesh.run_ranks`` starts each rank with ``spawn``, which pickles
the function by reference: the functions live at module level here, in a
module that imports neither pytest nor the reference package, so a rank
loads only torch and the port. Each rank runs the whole list of contracts
of one world once and returns numpy results; the test file asserts on
them against the port's in-process host executor.
"""
import os
import time

import numpy as np

HIDDEN = 16
BATCH = 8
FAMILIES = ("gcn", "sage", "saint")
ENGINE_NODES = 3 * BATCH


def cora():
    from repro_torch.graphs.datasets import make_dataset
    return make_dataset("cora", seed=0, scale=0.1)


def ragged():
    """117 nodes (not a tile multiple) with a hub cluster, so the
    edge-balanced cuts give shards of unequal row counts (the reference's
    ``test_spmd_bit_exact_ragged_rows`` graph)."""
    from repro_torch.graphs.datasets import GraphData
    n = 117
    rng = np.random.default_rng(3)
    src = np.concatenate([rng.integers(0, 10, 400), rng.integers(0, n, 200)])
    dst = np.concatenate([rng.integers(0, n, 400), rng.integers(0, n, 200)])
    keep = src != dst
    return GraphData(name="ragged",
                     x=rng.standard_normal((n, 24)).astype(np.float32),
                     y=rng.integers(0, 4, n).astype(np.int32),
                     edges=np.stack([src[keep], dst[keep]]).astype(np.int64),
                     n_classes=4, train_mask=np.zeros(n, bool),
                     val_mask=np.zeros(n, bool), test_mask=np.zeros(n, bool))


def make_store(data, families=FAMILIES, **kw):
    """A CPU GraphStore with the port's seeded models, the same in every
    process."""
    from repro_torch.models import gnn
    from repro_torch.serve import GraphStore
    st = GraphStore(max_batch=BATCH, device="cpu", **kw)
    st.register_graph("g", data)
    f, c = data.x.shape[1], data.n_classes
    for fam in families:
        st.register_model(fam, fam, getattr(gnn, f"init_{fam}")(
            0, f, HIDDEN, c, "cpu"))
    return st


def exchange_blocks(plan):
    """fp and packed uint32 row blocks of every shard (one seed)."""
    rng = np.random.default_rng(0)
    fp = [rng.standard_normal((p.n_local, 7)).astype(np.float32)
          for p in plan.parts]
    packed = [rng.integers(0, 2**32, size=(p.n_local, 3), dtype=np.uint32)
              for p in plan.parts]
    return fp, packed


def engine_nodes(n_nodes):
    return np.random.default_rng(7).integers(0, n_nodes, size=ENGINE_NODES)


def make_engine(store, n_shards, **kw):
    """The sharded engine of the engine contract: formation never waits
    on the clock (``staleness_s`` past any run), so every process forms
    the same batches from the same submissions."""
    from repro_torch.serve import ShardedServeEngine
    return ShardedServeEngine(store, n_shards, max_batch=BATCH,
                              mode="subgraph", staleness_s=1e9, **kw)


def grad(rank):
    return np.random.default_rng(100 + rank).standard_normal(128).astype(
        np.float32)


def _bn(bn):
    return [(mu.cpu().numpy(), sd.cpu().numpy()) for mu, sd in bn]


def contracts(rank, p):
    """Every contract of one world of ``p`` ranks; returns numpy. The
    ranks run at a lower priority: they share the host's cores with the
    other test workers, whose timing tests measure the CPU."""
    os.nice(10)
    import torch
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.quant.grad_compress import allreduce_1bit
    from repro_torch.serve.sharded import (ShardPlanner, build_mesh_plan,
                                           mesh_exchange)

    out = {"rank": rank}
    data = cora()
    # SPMD full passes, unfused and fused, against the host executor
    for fused in (False, True):
        st = make_store(data, use_pallas=fused, fused=fused)
        for fam in FAMILIES:
            s = st.sharded_session("g", fam, p, executor="spmd")
            key = f"{'fused' if fused else 'plain'}/{fam}"
            out[f"logits/{key}"] = s.full_logits()
            out[f"bn/{key}"] = _bn(s.bn)
            out[f"compiles/{key}"] = (s.executor_compile_count,
                                      len(s.program))
    st = make_store(ragged(), ("gcn", "sage"))
    for fam in ("gcn", "sage"):
        s = st.sharded_session("g", fam, p, executor="spmd")
        out[f"ragged/{fam}"] = s.full_logits()
        out[f"ragged_locals/{fam}"] = [pt.n_local for pt in s.parts]
    # the ring transport alone, and a host-executor session over it
    plan = ShardPlanner(p).plan(data, "gcn")
    mplan = build_mesh_plan(plan.routing, [pt.halo_nodes
                                           for pt in plan.parts])
    mesh = make_shard_mesh(p)
    fp, packed = exchange_blocks(plan)
    out["exchange/fp"] = mesh_exchange(mesh, fp, mplan)
    out["exchange/packed"] = mesh_exchange(mesh, packed, mplan)
    s = make_store(data, ("gcn",)).sharded_session("g", "gcn", p, mesh=mesh)
    out["mesh/logits"] = s.full_logits()
    out["mesh/serve"] = s.serve_subgraph(np.arange(BATCH))
    out["mesh/executor"] = (type(s.layer_executor).__name__,
                            s.layer_executor.mesh is mesh)
    if p != 2:
        return out
    # no new program after a feature update (on a graph of its own: the
    # store swaps the features of the registered data in place)
    st = make_store(cora(), ("sage",))
    s = st.sharded_session("g", "sage", p, executor="spmd")
    s.full_logits()
    c0 = s.executor_compile_count
    x2 = data.x.copy()
    x2[:10] = 0.5
    st.update_features("g", x2)
    out["update/logits"] = s.full_logits()
    out["update/counts"] = (c0, s.executor_compile_count, len(s.program),
                            s.invalidations)
    # distributed BN: SPMD against the host executor in the same rank
    st = make_store(data, ("sage",))
    h = st.sharded_session("g", "sage", p, bn_mode="distributed")
    s = st.sharded_session("g", "sage", p, executor="spmd",
                           bn_mode="distributed")
    out["dbn/host"] = (_bn(h.bn), h.full_logits())
    out["dbn/spmd"] = (_bn(s.bn), s.full_logits())
    # halo bytes from the static schedule, once per layer per pass
    st = make_store(data, ("gcn",))
    s = st.sharded_session("g", "gcn", p, executor="spmd")
    s.full_logits()
    tags1 = dict(s.halo_stats.bytes_by_tag)
    c1 = s.executor_compile_count
    s.run_distributed_pass()
    mp = s.shard_plan.spmd_plan().mesh_plan
    out["bytes"] = (tags1, dict(s.halo_stats.bytes_by_tag), c1,
                    s.executor_compile_count,
                    mp.payload_bytes(s.program[0].payload_cols, 4),
                    mp.payload_bytes(s.program[1].payload_cols, 4))
    # the engine with executor="spmd"
    st = make_store(data, ("gcn",))
    eng = make_engine(st, p, executor="spmd")
    qs = eng.submit_many("g", "gcn", engine_nodes(data.n_nodes))
    eng.run_until_drained()
    snap = eng.snapshot()
    out["engine"] = (np.stack([q.logits for q in qs]), snap["executor"],
                     snap["executor_compiles"],
                     eng.engine_config()["mesh"] is None)
    # the 1-bit all-reduce over the world
    out["allreduce"] = allreduce_1bit(torch.from_numpy(grad(rank)),
                                      mesh).numpy()
    return out


def fail_on_rank1(rank):
    """Rank 1 raises; rank 0 returns."""
    if rank == 1:
        raise ValueError("rank 1 was told to fail")
    return rank


def fail_on_rank0(rank):
    """Rank 0 raises; rank 1 runs on, outside any collective, far past
    ``run_ranks``'s grace."""
    if rank == 0:
        raise ValueError("rank 0 was told to fail")
    time.sleep(120)
    return rank


def mismatched_plans(rank):
    """Rank 1 builds the SPMD executor on another SpmdPlan than rank 0's:
    the construction's digest check must refuse it on every rank."""
    import dataclasses
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.serve import session_core
    from repro_torch.serve.sharded import (HaloStats, ShardPlanner,
                                           SpmdLayerExecutor)
    plan = ShardPlanner(2).plan(cora(), "gcn")
    spmd = plan.spmd_plan()
    if rank == 1:
        spmd = dataclasses.replace(spmd, n_halo_pad=spmd.n_halo_pad + 4)
    SpmdLayerExecutor(plan.parts, spmd, session_core.default_plan("gcn"),
                      HaloStats(), make_shard_mesh(2), device="cpu")
    return rank
