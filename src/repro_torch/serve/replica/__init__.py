"""Fault-tolerant replica tier (reference: ``repro/serve/replica``): host
Python over the port's engines, whose kernels run on the store's device.

``router``  — :class:`FrontDoor` (global admission, feature-version
              pinning, tenant/query spread, failover resubmission) over
              :class:`ReplicaHandle` replicas; :func:`build_replica`.
``health``  — heartbeat protocol: deadline + consecutive-fault detection,
              hysteretic recovery (:class:`HealthMonitor`,
              :class:`HealthPolicy`).
``faults``  — deterministic chaos seam (:class:`FaultInjector`): seeded
              probabilistic/counted stage failures, replica kills,
              heartbeat drops, artifact corruption.
``reshard`` — live P -> P' repartition (:class:`Resharder`): background
              double-buffered build, artifact consistency gate, atomic
              intake swap + graceful drain.
"""
from .faults import FaultInjector, InjectedFault
from .health import HealthMonitor, HealthPolicy
from .reshard import Resharder, ReshardReport
from .router import FrontDoor, ReplicaHandle, RoutedQuery, build_replica

__all__ = [
    "FaultInjector", "InjectedFault", "HealthMonitor", "HealthPolicy",
    "Resharder", "ReshardReport", "FrontDoor", "ReplicaHandle",
    "RoutedQuery", "build_replica",
]
