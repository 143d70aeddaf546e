"""Deterministic fault injection for the replica tier (reference:
``repro/serve/replica/faults.py``).

One :class:`FaultInjector` is shared by every component under test: engines
consult it at their extract/launch/complete stage boundaries (via the
``faults=`` seam on :class:`~repro_torch.serve.gnn_engine.GNNServeEngine`),
replica handles consult it in their heartbeat path, and the artifact
robustness tests use :meth:`corrupt_artifact` to damage checkpoint files on
disk. All randomness comes from one seeded generator and every mutating
call happens under one lock, so a chaos test replays identically
run-to-run.

Two rule flavors per operation:

* :meth:`fail` — probabilistic: every matching :meth:`check` fails with the
  given rate (rate 1.0 = always, until :meth:`clear`).
* :meth:`fail_next` — counted: exactly the next ``n`` matching checks fail,
  then the rule disarms itself. The workhorse of deterministic tests.

``scope`` narrows a rule to one engine: the replica tier stamps each
engine's ``fault_scope`` with its replica name, so ``fail("launch",
scope="r1")`` only trips replica r1's launches. A rule with ``scope=None``
matches every engine.
"""
from __future__ import annotations

import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

OPS = ("extract", "launch", "complete")


class InjectedFault(RuntimeError):
    """A deliberately injected failure (chaos testing). Engines treat it
    exactly like a real stage error: requeue + bounded retry."""

    def __init__(self, op: str, scope: Optional[str] = None):
        self.op = op
        self.scope = scope
        where = f" on {scope!r}" if scope else ""
        super().__init__(f"injected {op} fault{where}")


class FaultInjector:
    """Seeded, lockable registry of failure rules (see module docstring)."""

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        # (op, scope) -> failure probability [probabilistic rules]
        self._rates: Dict[Tuple[str, Optional[str]], float] = {}
        # (op, scope) -> remaining forced failures [counted rules]
        self._counts: Dict[Tuple[str, Optional[str]], int] = {}
        # replicas currently killed (their heartbeat path reports dead)
        self._killed: set = set()
        # replica -> heartbeats still to swallow (drop without killing)
        self._beat_drops: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}

    # ------------------------------------------------------------ rules ----
    def fail(self, op: str, rate: float = 1.0,
             scope: Optional[str] = None) -> None:
        """Fail matching checks with probability ``rate`` until cleared."""
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; have {OPS}")
        with self._lock:
            self._rates[(op, scope)] = float(rate)

    def fail_next(self, op: str, n: int = 1,
                  scope: Optional[str] = None) -> None:
        """Fail exactly the next ``n`` matching checks, then disarm."""
        if op not in OPS:
            raise ValueError(f"unknown op {op!r}; have {OPS}")
        with self._lock:
            self._counts[(op, scope)] = \
                self._counts.get((op, scope), 0) + int(n)

    def clear(self, op: Optional[str] = None) -> None:
        """Drop every rule for ``op`` (all ops when None). Kills and
        heartbeat drops are separate state (see :meth:`revive`)."""
        with self._lock:
            if op is None:
                self._rates.clear()
                self._counts.clear()
            else:
                for d in (self._rates, self._counts):
                    for k in [k for k in d if k[0] == op]:
                        del d[k]

    # ------------------------------------------------------------ check ----
    def check(self, op: str, scope: Optional[str] = None) -> None:
        """Stage-boundary hook: raise :class:`InjectedFault` when a rule
        matches ``op`` for this engine's ``scope`` (scoped rules first,
        then global ones)."""
        with self._lock:
            for key in ((op, scope), (op, None)):
                if self._counts.get(key, 0) > 0:
                    self._counts[key] -= 1
                    self._fired[op] = self._fired.get(op, 0) + 1
                    raise InjectedFault(op, scope)
                rate = self._rates.get(key)
                if rate is not None and self._rng.random() < rate:
                    self._fired[op] = self._fired.get(op, 0) + 1
                    raise InjectedFault(op, scope)

    # --------------------------------------------------- replica chaos ----
    def kill(self, name: str) -> None:
        """Hard-kill replica ``name``: its heartbeat path reports dead
        until :meth:`revive`."""
        with self._lock:
            self._killed.add(name)

    def revive(self, name: str) -> None:
        with self._lock:
            self._killed.discard(name)

    def is_killed(self, name: str) -> bool:
        with self._lock:
            return name in self._killed

    def drop_heartbeats(self, name: str, n: int = 1) -> None:
        """Swallow the next ``n`` heartbeats from ``name`` WITHOUT killing
        it — a replica that looks dead but isn't (the health monitor must
        still fail it over, and recovery must re-admit it)."""
        with self._lock:
            self._beat_drops[name] = self._beat_drops.get(name, 0) + int(n)

    def take_heartbeat_drop(self, name: str) -> bool:
        """Consume one pending heartbeat drop for ``name`` (True = this
        beat is swallowed)."""
        with self._lock:
            left = self._beat_drops.get(name, 0)
            if left <= 0:
                return False
            self._beat_drops[name] = left - 1
            return True

    # -------------------------------------------------------- artifacts ----
    def corrupt_artifact(self, path, keep_bytes: Optional[int] = None
                         ) -> Path:
        """Byte-truncate an on-disk artifact (default: cut it in half) —
        the checkpoint-robustness chaos: the next load must raise a typed
        ``ArtifactError`` naming this file, never a bare parser error."""
        path = Path(path)
        data = path.read_bytes()
        if keep_bytes is None:
            keep_bytes = len(data) // 2
        path.write_bytes(data[:max(0, int(keep_bytes))])
        return path

    def snapshot(self) -> dict:
        with self._lock:
            return dict(
                rates={f"{op}@{scope or '*'}": r
                       for (op, scope), r in self._rates.items()},
                counts={f"{op}@{scope or '*'}": c
                        for (op, scope), c in self._counts.items() if c},
                killed=sorted(self._killed),
                beat_drops=dict(self._beat_drops),
                fired=dict(self._fired))
