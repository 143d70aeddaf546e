"""Live reshard: repartition one replica P -> P' without dropping queries
(reference: ``repro/serve/replica/reshard.py``).

The sequence the :class:`Resharder` drives:

1. **Persist** — save the replica's current sharded session to the artifact
   directory (checkpointer shards + ``routing.json`` sidecar), exactly the
   artifacts a cold start would restore from.
2. **Verify** — read the sidecar back through the typed loader and check
   its fingerprint against the LIVE store: a reshard must never proceed
   from artifacts that describe a different graph/model than the one
   serving traffic (a stale artifact directory raises ``ArtifactError``
   before any traffic moves).
3. **Build** — compile the P' session in the background (double-buffered:
   the old engine keeps serving the whole time), spin a new engine over it
   with the old engine's own ``engine_config()`` (same admission policies,
   tracer ring, retry discipline, chaos seam), and warm its shape buckets
   so the swapped-in engine serves with zero steady-state recompiles.
4. **Validate** — the old and new routing tables must contiguously cover
   the same node id space (:func:`~repro_torch.serve.sharded.planner
   .validate_reshard`).
5. **Swap** — atomically redirect the replica's intake to the new engine,
   then drain the old one: its backlog and in-flight batches finish on the
   OLD partitioning (both partitionings are bit-exact, so answers don't
   care), and the drain report proves nothing was lost.

Bit-exactness falls out of the sharded session's core guarantee (any P
produces identical answers), which the chaos tests assert end-to-end:
a reshard under load yields the same logits as a freshly built P' stack.

On the card, the background build launches kernels from the resharder's
thread while the old engine launches from the serving thread. Both use
their thread's current stream, the device's default stream unless a caller
set another: the engine's in-flight CUDA event, recorded after its own
launch, completes only once everything queued before it on that stream is
done, so it is never taken as done before its own batch. torch's sync debug
mode, which the transfer watchdog's strict guard sets, is one setting for
the whole process (JAX's transfer guard is per thread), and the build
synchronizes (BN calibration, the logits caches, warmup): the build holds
:data:`~repro_torch.serve.trace.SYNC_EXCLUSIVE`, which a strict guard also
takes, so the two never overlap. Both sessions get the old engine's
``mesh``, as in the reference: where P' differs from the mesh's size the
new session's host executor runs the loopback exchange.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from pathlib import Path
from typing import Optional

from .. import session_core
from ..gnn_engine import DrainReport
from ..trace import SYNC_EXCLUSIVE
from ..sharded.planner import validate_reshard
from ..sharded.routing import RoutingTable
from .router import ReplicaHandle


@dataclasses.dataclass
class ReshardReport:
    """Outcome of one completed reshard swap."""
    replica: str
    graph: str
    model: str
    from_shards: int
    to_shards: int
    prepare_s: float
    swap_s: float
    drain: DrainReport

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["drain"] = self.drain.to_json()
        return d


class Resharder:
    """Background build + atomic swap of one replica's shard count."""

    def __init__(self, handle: ReplicaHandle, graph: str, model: str,
                 to_shards: int, artifact_dir=None,
                 drain_timeout_s: float = 30.0, tracer=None):
        if to_shards < 1:
            raise ValueError(f"to_shards must be >= 1, got {to_shards}")
        self.handle = handle
        self.graph = graph
        self.model = model
        self.to_shards = int(to_shards)
        self.artifact_dir = Path(artifact_dir) if artifact_dir else None
        self.drain_timeout_s = float(drain_timeout_s)
        self.tracer = tracer
        self._new_engine = None
        self._old_routing: Optional[RoutingTable] = None
        self._prepare_s = 0.0
        self._error: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- prepare ----
    def _emit(self, name: str, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.event(name, **attrs)

    def _prepare(self) -> None:
        with SYNC_EXCLUSIVE:
            self._build()

    def _build(self) -> None:
        t0 = time.perf_counter()
        old_engine = self.handle.engine
        store = self.handle.store
        from_shards = getattr(old_engine, "n_shards", 0)
        old_session = store.sharded_session(
            self.graph, self.model, from_shards,
            mesh=getattr(old_engine, "mesh", None),
            executor=getattr(old_engine, "executor", "host"),
            bn_mode=getattr(old_engine, "bn_mode", "single_host")) \
            if from_shards >= 1 else None
        if old_session is None:
            raise ValueError(
                f"replica {self.handle.name!r} is not sharded "
                f"(n_shards={from_shards}); reshard needs a sharded engine")
        self._old_routing = old_session.routing
        # 1. persist the live partitioning + 2. verify the artifacts read
        # back consistent with the store we are about to repartition
        if self.artifact_dir is not None:
            sess_dir = self.artifact_dir / (
                f"{self.graph}__{self.model}__P{from_shards}")
            old_session.save(sess_dir)
            sidecar = session_core.load_sidecar(
                sess_dir / "routing.json",
                required=("fingerprint", "routing", "n_shards"))
            if sidecar is None:
                raise session_core.ArtifactError(
                    sess_dir / "routing.json",
                    detail="reshard artifacts unreadable after save")
            live_fp = old_session.fingerprint()
            if sidecar["fingerprint"] != live_fp:
                raise session_core.ArtifactError(
                    sess_dir / "routing.json", field="fingerprint",
                    detail="artifact describes a different graph/model "
                           "than the live store")
        # 3. build the P' session + engine in the background (the old
        # engine keeps serving off its own session the whole time)
        new_session = store.sharded_session(
            self.graph, self.model, self.to_shards,
            mesh=getattr(old_engine, "mesh", None),
            executor=getattr(old_engine, "executor", "host"),
            bn_mode=getattr(old_engine, "bn_mode", "single_host"))
        # 4. routing-cover validation before any traffic moves
        validate_reshard(self._old_routing, new_session.routing,
                         store.graphs[self.graph].data.n_nodes)
        cfg = old_engine.engine_config()
        new_engine = type(old_engine)(store, self.to_shards, **cfg)
        new_engine.warmup(self.graph, self.model)
        self._new_engine = new_engine
        self._prepare_s = time.perf_counter() - t0
        self._emit("reshard", phase="prepared", replica=self.handle.name,
                   from_shards=from_shards, to_shards=self.to_shards,
                   prepare_s=self._prepare_s)

    def prepare(self, block: bool = True) -> "Resharder":
        """Build the P' stack. ``block=False`` runs it on a background
        thread (poll :attr:`ready`); errors surface at :meth:`swap`."""
        if block:
            self._prepare()
            return self

        def run():
            try:
                self._prepare()
            except BaseException as e:
                self._error = e
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="resharder")
        self._thread.start()
        return self

    @property
    def ready(self) -> bool:
        return self._new_engine is not None or self._error is not None

    # ------------------------------------------------------------- swap ----
    def swap(self) -> ReshardReport:
        """Atomically redirect intake to the P' engine, drain the old one
        (its queued/in-flight work completes on the old partitioning), and
        shut it down. Returns the report; raises whatever a background
        :meth:`prepare` raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            raise self._error
        if self._new_engine is None:
            raise RuntimeError("swap() before prepare()")
        old_engine = self.handle.engine
        from_shards = getattr(old_engine, "n_shards", 0)
        t0 = time.perf_counter()
        self._emit("reshard", phase="swap_begin", replica=self.handle.name,
                   from_shards=from_shards, to_shards=self.to_shards)
        old = self.handle.swap_engine(self._new_engine)
        report = old.drain(self.drain_timeout_s)
        old.close()
        swap_s = time.perf_counter() - t0
        self._emit("reshard", phase="swap_end", replica=self.handle.name,
                   from_shards=from_shards, to_shards=self.to_shards,
                   swap_s=swap_s, drained=report.to_json())
        return ReshardReport(
            replica=self.handle.name, graph=self.graph, model=self.model,
            from_shards=from_shards, to_shards=self.to_shards,
            prepare_s=self._prepare_s, swap_s=swap_s, drain=report)
