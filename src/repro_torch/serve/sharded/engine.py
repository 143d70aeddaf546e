"""ShardedServeEngine: micro-batched node queries over partitioned sessions
(reference: ``repro/serve/sharded/engine.py``).

Same queueing/metrics/warmup discipline as
:class:`~repro_torch.serve.gnn_engine.GNNServeEngine` (it IS one — the
scheduler, including the two-stage extract/compute pipeline, is
inherited); what changes:

  * **session resolution** — a queue key resolves to the store's
    :class:`~.session.ShardedGraphSession` for this engine's shard count; a
    served micro-batch is routed inside the session, each query's k-hop
    neighborhood answered by its seed's owning shard with remote rows
    fetched over the halo transport;
  * **halo-aware batch formation** — queues are keyed by owning shard
    (single-owner micro-batches, the bit-exactness invariant), and within a
    queue the strict FIFO pop is replaced by signature grouping: each seed's
    cheap halo signature (the FRDC tile ids of its remote 1-hop neighbors,
    :meth:`~.session.ShardedGraphSession.seed_halo_tiles`) lets formation
    greedily co-batch seeds whose k-hop closures request the same halo
    tiles, so the ``serve/x`` feature gather — the single largest halo byte
    tag — is issued once per shared tile instead of once per seed. A
    **staleness bound** caps the reordering: a request in the formation
    window whose wait exceeds ``staleness_s`` is taken in FIFO order by the
    next batch formed from its queue, never skipped for better overlap.

``mode`` defaults to ``"subgraph"``: the routed path is the scale path (a
sharded deployment serves graphs no single device could hold, so the
full-graph cache is per-shard and used only when asked for).

``snapshot()`` additionally reports halo traffic (bytes by layer/tag),
per-shard compile counters, and the formation counters
(``halo_tiles_shared`` / ``halo_bytes_saved`` — the signature-level halo
volume co-batching deduplicated vs a once-per-seed gather; the benchmark
additionally MEASURES the ``serve/x`` delta vs a strict-FIFO engine).

The sessions run the host layer executor on the store's device; ``mesh``
(the reference's halo transport over a device mesh) must stay None until
the multi-card slice ports it.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...core import frdc
from ..admission import DEFAULT_TENANT
from ..gnn_engine import GNNServeEngine, NodeQuery
from ..gnn_session import GraphStore


class ShardedServeEngine(GNNServeEngine):
    """Micro-batching scheduler over a store's SHARDED sessions."""

    def __init__(self, store: GraphStore, n_shards: int,
                 max_batch=None, mode: str = "subgraph",
                 full_cache_max_nodes: int = 200_000,
                 keep_finished: int = 100_000, mesh=None,
                 executor: str = "host", bn_mode: str = "single_host",
                 pipeline_depth: int = 0, halo_aware: bool = True,
                 staleness_s: float = 0.25,
                 halo_window: Optional[int] = None, admission=None,
                 tracer=None, trace: bool = True, cost=None, slo=None,
                 multi_bucket: bool = False, faults=None,
                 max_retries: int = 8, retry_backoff_s: float = 0.05,
                 retry_backoff_max_s: float = 2.0):
        super().__init__(store, max_batch=max_batch, mode=mode,
                         full_cache_max_nodes=full_cache_max_nodes,
                         keep_finished=keep_finished,
                         pipeline_depth=pipeline_depth, admission=admission,
                         tracer=tracer, trace=trace, cost=cost, slo=slo,
                         multi_bucket=multi_bucket, faults=faults,
                         max_retries=max_retries,
                         retry_backoff_s=retry_backoff_s,
                         retry_backoff_max_s=retry_backoff_max_s)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        # mesh= mirrors the reference's signature and waits for the halo
        # transport across cards (ROADMAP Queue 1 item 5); nothing reads it
        if mesh is not None:
            raise NotImplementedError(
                "mesh= is not ported: the halo transport over cards comes "
                "with the multi-card slice; leave mesh=None")
        self.n_shards = n_shards
        self.mesh = mesh
        self.executor = executor
        self.bn_mode = bn_mode
        self.halo_aware = halo_aware
        self.staleness_s = float(staleness_s)
        # how deep into a queue signature grouping may look for co-batching
        # candidates (bounds the formation cost per slot)
        self.halo_window = halo_window
        self.halo_tiles_shared = 0       # co-batched shared halo tiles
        self.halo_bytes_saved = 0        # est. serve/x bytes they deduplicate
        self.whale_splits = 0            # batches closed early to avoid
        #                                  co-batching two predicted whales
        # formation stats of the most recent _pop_batch, stashed for the
        # batch's trace (single extract worker: read before the next pop)
        self._last_formation: dict = {}
        self._routing_cache = {}
        self._sig_cache: Dict[Tuple[str, str], Dict[int, frozenset]] = {}
        self._feat_bytes_cache: Dict[Tuple[str, str], int] = {}

    def _get_session(self, key: Tuple[str, ...]):
        return self.store.sharded_session(*key[:2], self.n_shards,
                                          executor=self.executor,
                                          bn_mode=self.bn_mode)

    def engine_config(self) -> dict:
        """Rebuild kwargs incl. the sharded knobs — everything except the
        store and ``n_shards``, which the reshard path supplies (that pair
        IS the thing a reshard changes)."""
        cfg = super().engine_config()
        cfg.update(mesh=self.mesh, executor=self.executor,
                   bn_mode=self.bn_mode, halo_aware=self.halo_aware,
                   staleness_s=self.staleness_s,
                   halo_window=self.halo_window)
        return cfg

    def _queue_key(self, graph: str, model: str, node: int,
                   tenant: str = DEFAULT_TENANT) -> tuple:
        """One FIFO per (graph, model, owning shard, tenant): every served
        micro-batch is a single-owner group, so its routed subgraph — and
        therefore its logits — are bit-identical to the single-host session
        serving the same batch. Keeping the tenant in the key (LAST, the
        admission controller's convention) means halo-aware co-batching
        only ever groups seeds within one tenant's owner queue, so the
        single-owner bit-exactness invariant and the replayed ``batch_log``
        oracle survive tenancy unchanged.

        The routing bounds are cached per (graph, model); steady-state
        intake is one scalar bisection. NOTE: the FIRST submit for a pair
        whose sharded session is not built yet triggers the plan + compile
        (call ``engine.warmup(graph, model)`` beforehand to keep the intake
        path cheap, exactly like pre-warming the single-host engine)."""
        bounds = self._routing_cache.get((graph, model))
        if bounds is None:
            bounds = self._get_session((graph, model)).routing.bounds
            self._routing_cache[(graph, model)] = bounds
        owner = int(np.searchsorted(bounds, node, side="right")) - 1
        return (graph, model, owner, tenant)

    # -------------------------------------------- halo-aware formation -----
    # bound per (graph, model): a long-lived engine on a huge graph must
    # not accumulate one signature per node ever queried (the finished/
    # batch_log deques are bounded for the same reason)
    SIG_CACHE_MAX = 262_144

    def _seed_signature(self, session, graph: str, model: str,
                        node: int) -> frozenset:
        """Cached per-seed halo signature (structural: valid for the life of
        the graph's partition). ``session`` is the already-resolved sharded
        session — a cache miss is one CSR row read, cheap enough for the
        formation loop."""
        cache = self._sig_cache.setdefault((graph, model), {})
        sig = cache.get(node)
        if sig is None:
            if len(cache) >= self.SIG_CACHE_MAX:
                cache.pop(next(iter(cache)))     # evict oldest-inserted
            sig = session.seed_halo_tiles(node)
            cache[node] = sig
        return sig

    def _feat_row_bytes(self, graph: str, model: str) -> int:
        b = self._feat_bytes_cache.get((graph, model))
        if b is None:
            x = self.store.graphs[graph].data.x
            b = int(x.shape[1]) * x.dtype.itemsize
            self._feat_bytes_cache[(graph, model)] = b
        return b

    def _cost_halo_rows(self, graph: str, model: str,
                        node: int) -> Tuple[int, int]:
        """Predicted halo traffic of one seed from its static halo
        signature: every remote FRDC tile the signature names is
        ``frdc.TILE`` feature rows of ``serve/x`` gather — the same
        per-tile accounting the halo plan's ``payload_bytes`` uses. Reads
        only the cached signature/routing state ``_queue_key`` resolves on
        the same submit path."""
        session = self._get_session((graph, model))
        sig = self._seed_signature(session, graph, model, node)
        return len(sig) * frdc.TILE, self._feat_row_bytes(graph, model)

    def _prepare_formation(self, key: tuple, session) -> None:
        """Warm the halo-signature cache for every request the upcoming
        formation may touch — OUTSIDE ``_qlock``, so the locked pop does no
        CSR reads. The queue is snapshotted briefly; requests submitted
        between snapshot and pop fall back to the (cheap, one-row) in-lock
        cache miss."""
        if not self.halo_aware:
            return
        graph, model = key[0], key[1]
        window = (8 * self.max_batch if self.halo_window is None
                  else self.halo_window)
        with self._qlock:
            dq = self._queues.get(key)
            nodes = [q.node for q in
                     itertools.islice(dq or (), window + self.max_batch)]
        self._feat_row_bytes(graph, model)
        for n in nodes:
            self._seed_signature(session, graph, model, n)

    def _pop_batch(self, key: tuple, session) -> List[NodeQuery]:
        """Halo-aware batch formation (caller holds ``_qlock``): start from
        the queue head (the oldest request is never delayed by grouping),
        then fill the batch greedily with the in-window candidate sharing
        the most halo-signature tiles with the batch so far — EXCEPT that
        any request in the formation window whose wait already exceeds
        ``staleness_s`` preempts the grouping and is taken in FIFO order
        (the earliest overdue one first), so an overdue request is never
        skipped for better overlap. Queues are keyed by owning shard, so
        any formed batch is single-owner by construction. With no signature
        overlap anywhere (``halo_window=0``, or ``halo_aware=False``) this
        degrades to exactly the FIFO pop."""
        if not self.halo_aware:
            self._last_formation = {}
            return super()._pop_batch(key, session)
        graph, model = key[0], key[1]
        dq = self._queues[key]
        limit = min(self.max_batch, len(dq))
        now = time.perf_counter()
        window = (8 * self.max_batch if self.halo_window is None
                  else self.halo_window)
        batch = [dq.popleft()]
        sig = set(self._seed_signature(session, graph, model, batch[0].node))
        row_bytes = self._feat_row_bytes(graph, model)
        form_shared, form_saved = 0, 0
        # whale avoidance: with a cost model, a batch already carrying one
        # predicted whale never greedily picks up another — two whales in
        # one micro-batch make its padded bucket (and so EVERY member's
        # latency) pay for both closures. The staleness bound still wins:
        # an overdue whale is taken, never skipped.
        has_whale = self.cost is not None \
            and self.cost.is_whale(batch[0].cost)
        form_whale_split = False
        while len(batch) < limit and dq:
            # staleness bound: the earliest overdue request anywhere in the
            # window wins over signature grouping (the deque is in submit
            # order, so the first overdue found is the oldest)
            overdue_i = None
            for i, cand in enumerate(dq):
                if i >= window:
                    break
                if now - cand.t_submit >= self.staleness_s:
                    overdue_i = i
                    break
            if overdue_i is not None:
                q = dq[overdue_i]
                del dq[overdue_i]
            else:
                best_i, best_score = None, -1
                for i, cand in enumerate(dq):
                    if i >= window:
                        break
                    if has_whale and self.cost.is_whale(cand.cost):
                        continue
                    score = len(sig & self._seed_signature(
                        session, graph, model, cand.node))
                    if score > best_score:
                        best_i, best_score = i, score
                if best_i is None:
                    # every in-window candidate is another whale: close
                    # the batch early and leave them for their own batches
                    self.whale_splits += 1
                    form_whale_split = True
                    break
                q = dq[best_i]
                del dq[best_i]
            csig = self._seed_signature(session, graph, model, q.node)
            shared = len(sig & csig)
            if shared:
                self.halo_tiles_shared += shared
                self.halo_bytes_saved += shared * frdc.TILE * row_bytes
                form_shared += shared
                form_saved += shared * frdc.TILE * row_bytes
            sig |= csig
            batch.append(q)
            if self.cost is not None and self.cost.is_whale(q.cost):
                has_whale = True
        self._last_formation = dict(tiles=len(sig),
                                    tiles_shared=form_shared,
                                    bytes_saved=form_saved)
        if form_whale_split:
            self._last_formation["whale_split"] = True
        return batch

    # ------------------------------------------------------- trace hooks ---
    def _trace_shard(self, key: tuple):
        return int(key[2])       # (graph, model, owner, tenant)

    def _trace_halo_begin(self, session):
        """Snapshot the serve-path halo byte counter so the batch's trace
        carries ITS halo traffic (single extract worker: the delta across
        prepare_batch is this batch's)."""
        return int(session.halo_stats.bytes_by_tag.get("serve/x", 0))

    def _trace_halo_end(self, session, token) -> dict:
        out = dict(self._last_formation)
        if token is not None:
            now = int(session.halo_stats.bytes_by_tag.get("serve/x", 0))
            out["serve_x_bytes"] = now - token
        return out

    # ------------------------------------------------------------- state ---
    def _sessions(self):
        return (s for k, s in self.store._sharded_sessions.items()
                if k[2] == self.n_shards and k[3] == self.executor
                and k[4] == self.bn_mode)

    @property
    def compile_count_by_shard(self):
        totals = [0] * self.n_shards
        for s in self._sessions():
            for i, c in enumerate(s.compile_count_by_shard):
                totals[i] += c
        return totals

    def snapshot(self) -> dict:
        snap = super().snapshot()
        halo = {}
        total = 0
        for s in self._sessions():
            for tag, b in s.halo_stats.bytes_by_tag.items():
                halo[tag] = halo.get(tag, 0) + b
                total += b
        snap.update(n_shards=self.n_shards, halo_bytes=total,
                    halo_bytes_by_tag=halo,
                    compiles_by_shard=self.compile_count_by_shard,
                    executor=self.executor, bn_mode=self.bn_mode,
                    executor_compiles=sum(s.executor_compile_count
                                          for s in self._sessions()),
                    halo_aware=self.halo_aware,
                    halo_tiles_shared=self.halo_tiles_shared,
                    halo_bytes_saved=self.halo_bytes_saved,
                    whale_splits=self.whale_splits)
        return snap
