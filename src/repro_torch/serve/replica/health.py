"""Replica health protocol: heartbeats, deadline detection, recovery
(reference: ``repro/serve/replica/health.py``).

The front door beats every replica each :meth:`FrontDoor.tick`; a replica
whose beats stop arriving (killed, or its heartbeats are being injected
away) misses the :attr:`HealthPolicy.deadline_s` deadline and is marked
unhealthy — the front door then fails its in-flight work over to survivors.
Serving faults count too: ``fault_threshold`` consecutive stage errors on
one replica mark it unhealthy without waiting for the deadline (a replica
that answers heartbeats but can't serve is still down).

Recovery is symmetric: once an unhealthy replica's beats come back,
``recovery_beats`` consecutive good beats re-admit it (hysteresis — one
lucky beat from a flapping replica must not bounce traffic back).

All clock inputs are explicit (``now`` parameters): the monitor never reads
wall time itself, so tests drive it deterministically.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Detection/recovery knobs: miss a beat for ``deadline_s`` -> down;
    ``fault_threshold`` consecutive serve faults -> down; ``recovery_beats``
    consecutive good beats -> back up."""
    deadline_s: float = 0.25
    fault_threshold: int = 3
    recovery_beats: int = 2


@dataclasses.dataclass
class _ReplicaHealth:
    last_beat: float
    healthy: bool = True
    consecutive_faults: int = 0
    good_beats: int = 0
    missed_beats: int = 0
    transitions: int = 0            # healthy <-> unhealthy flips


class HealthMonitor:
    """Tracks per-replica liveness for the front door (see module doc)."""

    def __init__(self, policy: Optional[HealthPolicy] = None, tracer=None):
        self.policy = policy or HealthPolicy()
        self.tracer = tracer
        self._replicas: Dict[str, _ReplicaHealth] = {}

    def register(self, name: str, now: float) -> None:
        self._replicas[name] = _ReplicaHealth(last_beat=now)

    def healthy(self, name: str) -> bool:
        st = self._replicas.get(name)
        return st is not None and st.healthy

    def healthy_names(self) -> List[str]:
        return [n for n, st in self._replicas.items() if st.healthy]

    def _emit(self, event: str, name: str, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.event(event, replica=name, **attrs)

    def _mark_down(self, name: str, reason: str, **attrs) -> None:
        st = self._replicas[name]
        if st.healthy:
            st.healthy = False
            st.transitions += 1
            self._emit("replica_unhealthy", name, reason=reason, **attrs)
        st.good_beats = 0

    # ------------------------------------------------------------ beats ----
    def beat(self, name: str, ok: bool, now: float) -> Optional[str]:
        """Fold one heartbeat result in. Returns ``"up"`` exactly when this
        beat completes an unhealthy replica's recovery (the front door
        re-admits it then), else None."""
        st = self._replicas[name]
        if not ok:
            st.missed_beats += 1
            st.good_beats = 0
            return None
        st.last_beat = now
        if st.healthy:
            return None
        st.good_beats += 1
        if st.good_beats >= self.policy.recovery_beats:
            st.healthy = True
            st.transitions += 1
            st.consecutive_faults = 0
            st.good_beats = 0
            self._emit("replica_recovered", name)
            return "up"
        return None

    def check(self, now: float) -> List[str]:
        """Deadline scan: replicas newly marked unhealthy because their
        last good beat is older than ``deadline_s``."""
        newly_down = []
        for name, st in self._replicas.items():
            if st.healthy and now - st.last_beat > self.policy.deadline_s:
                self._mark_down(name, "heartbeat deadline missed",
                                silent_s=now - st.last_beat)
                newly_down.append(name)
        return newly_down

    # ----------------------------------------------------- serve faults ----
    def fault(self, name: str, err: str, now: float) -> bool:
        """Fold one serving fault in; True when it crossed the consecutive
        threshold and newly marked the replica unhealthy."""
        st = self._replicas[name]
        st.consecutive_faults += 1
        if st.healthy and \
                st.consecutive_faults >= self.policy.fault_threshold:
            self._mark_down(name, "consecutive serve faults",
                            faults=st.consecutive_faults, error=err)
            return True
        return False

    def served(self, name: str) -> None:
        """A successful serve resets the consecutive-fault run."""
        st = self._replicas.get(name)
        if st is not None:
            st.consecutive_faults = 0

    def snapshot(self) -> dict:
        return {name: dict(healthy=st.healthy, last_beat=st.last_beat,
                           consecutive_faults=st.consecutive_faults,
                           missed_beats=st.missed_beats,
                           transitions=st.transitions)
                for name, st in sorted(self._replicas.items())}
