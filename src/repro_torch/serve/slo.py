"""Per-tenant SLOs: error-budget accounting, burn-rate alerts, and the
admission feedback loop (reference: ``repro/serve/slo.py``, copied).

An :class:`SLOPolicy` states a tenant's contract — target p99 latency and an
availability objective. The :class:`SLOTracker` watches the engine's
answered/rejected event stream and turns it into SRE-style error budgets:

  * every event is classified good/bad (a rejected submission, or an answer
    slower than the target p99, burns budget);
  * **burn rate** over a sliding window is the bad fraction divided by the
    budget fraction ``1 - availability`` — burn 1.0 consumes exactly the
    budget over the window, burn 10 consumes it 10x too fast;
  * alerts use the standard **multi-window** rule: a structured
    ``slo_burn`` :class:`~repro_torch.serve.trace.WarningEvent` fires (into the
    engine's span tracer, so it lands in the Chrome-trace and Prometheus
    exports) only when BOTH the short and the long window burn above the
    threshold — the short window gates on what is happening NOW, the long
    window keeps a transient blip from paging;
  * **feedback**: when a tenant's long-window burn stays above the alert
    threshold, :meth:`check` shrinks the tenant's effective
    ``max_queue_depth`` on the :class:`~repro_torch.serve.admission.
    AdmissionController` (multiplicative decrease, floored at
    ``min_depth_scale``) so overload is shed EARLIER, before it queues into
    latency; once the burn falls back under ``relax_burn`` the scale decays
    back toward 1.0.

The tracker is driven under the engine's ``_qlock`` (same discipline as the
admission controller) and takes explicit ``now`` timestamps, so tests and
benchmarks run it on an injected clock.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """One tenant's serving contract.

    ``target_p99_ms``   answered slower than this burns budget
                        (``inf`` = latency never burns);
    ``availability``    good-event objective in (0, 1) — the error budget
                        is ``1 - availability``;
    ``window_s``        long burn window (the budget accounting window);
    ``short_window_s``  fast burn window (default ``window_s / 10``);
    ``burn_alert``      multi-window alert threshold on the burn rate;
    ``relax_burn``      long-window burn below this relaxes the depth scale
                        back toward 1.0;
    ``autotune``        whether breaches shrink the tenant's effective
                        queue depth on the admission controller;
    ``min_depth_scale`` floor of the multiplicative depth shrink.
    """
    target_p99_ms: float = math.inf
    availability: float = 0.999
    window_s: float = 300.0
    short_window_s: Optional[float] = None
    burn_alert: float = 2.0
    relax_burn: float = 0.5
    autotune: bool = True
    min_depth_scale: float = 0.125

    def __post_init__(self):
        if not 0.0 < self.availability < 1.0:
            raise ValueError(f"availability must be in (0, 1), "
                             f"got {self.availability}")
        if not self.window_s > 0:
            raise ValueError(f"window_s must be > 0, got {self.window_s}")
        if self.short_window_s is not None \
                and not 0 < self.short_window_s <= self.window_s:
            raise ValueError(f"short_window_s must be in (0, window_s], "
                             f"got {self.short_window_s}")
        if not self.burn_alert > 0:
            raise ValueError(f"burn_alert must be > 0, "
                             f"got {self.burn_alert}")
        if not 0.0 < self.min_depth_scale <= 1.0:
            raise ValueError(f"min_depth_scale must be in (0, 1], "
                             f"got {self.min_depth_scale}")

    @property
    def budget(self) -> float:
        """The error-budget fraction: allowed bad events / events."""
        return 1.0 - self.availability

    @property
    def short_s(self) -> float:
        return self.short_window_s if self.short_window_s is not None \
            else self.window_s / 10.0


class _TenantBudget:
    """Sliding-window good/bad event stream of one tenant."""

    __slots__ = ("events", "alerts", "last_alert_t", "depth_scale",
                 "depth_shrinks", "depth_relaxes", "good", "bad")

    def __init__(self):
        self.events: Deque[Tuple[float, bool]] = deque()   # (t, bad)
        self.alerts = 0
        self.last_alert_t = -math.inf
        self.depth_scale = 1.0
        self.depth_shrinks = 0
        self.depth_relaxes = 0
        self.good = 0          # lifetime counters
        self.bad = 0


class SLOTracker:
    """Error budgets + burn-rate alerts + the admission feedback loop for
    the tenants that declared an :class:`SLOPolicy` (others are ignored —
    tenancy without an SLO costs nothing)."""

    def __init__(self, policies: Dict[str, SLOPolicy],
                 tracer=None, alert_cooldown_s: Optional[float] = None):
        self._policies = dict(policies or {})
        self.tracer = tracer
        # default cooldown: one alert per short window per tenant
        self.alert_cooldown_s = alert_cooldown_s
        self._tenants: Dict[str, _TenantBudget] = {}

    def policy(self, tenant: str) -> Optional[SLOPolicy]:
        return self._policies.get(tenant)

    def set_policy(self, tenant: str, policy: SLOPolicy) -> None:
        self._policies[tenant] = policy

    def _state(self, tenant: str) -> _TenantBudget:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantBudget()
        return st

    # ------------------------------------------------------------- intake ---
    def observe(self, tenant: str, now: float,
                latency_s: Optional[float] = None,
                rejected: bool = False) -> None:
        """Fold one event in: an answered query (``latency_s``) or a
        rejected submission (throttle/shed — an availability violation)."""
        pol = self._policies.get(tenant)
        if pol is None:
            return
        bad = bool(rejected)
        if not bad and latency_s is not None \
                and latency_s * 1e3 > pol.target_p99_ms:
            bad = True
        st = self._state(tenant)
        st.events.append((now, bad))
        if bad:
            st.bad += 1
        else:
            st.good += 1
        self._prune(st, pol, now)

    def _prune(self, st: _TenantBudget, pol: SLOPolicy, now: float) -> None:
        horizon = now - pol.window_s
        ev = st.events
        while ev and ev[0][0] < horizon:
            ev.popleft()

    def burn_rate(self, tenant: str, window_s: float,
                  now: float) -> float:
        """Bad fraction over the trailing window divided by the budget
        fraction (0.0 with no events in the window)."""
        pol = self._policies.get(tenant)
        st = self._tenants.get(tenant)
        if pol is None or st is None:
            return 0.0
        horizon = now - window_s
        total = bad = 0
        for t, b in reversed(st.events):
            if t < horizon:
                break
            total += 1
            bad += b
        if total == 0:
            return 0.0
        return (bad / total) / max(pol.budget, 1e-9)

    # ----------------------------------------------------- alerts/feedback ---
    def check(self, now: float, admission=None) -> list:
        """Evaluate every tracked tenant: fire ``slo_burn`` warnings at
        multi-window burn breaches (cooldown-limited) and, when
        ``admission`` is given, auto-tune the tenant's effective queue
        depth. Returns the alert dicts fired this call."""
        fired = []
        for tenant, st in self._tenants.items():
            pol = self._policies.get(tenant)
            if pol is None or not st.events:
                continue
            self._prune(st, pol, now)
            burn_long = self.burn_rate(tenant, pol.window_s, now)
            burn_short = self.burn_rate(tenant, pol.short_s, now)
            breach = (burn_long >= pol.burn_alert
                      and burn_short >= pol.burn_alert)
            cooldown = self.alert_cooldown_s if self.alert_cooldown_s \
                is not None else pol.short_s
            if breach and now - st.last_alert_t >= cooldown:
                st.alerts += 1
                st.last_alert_t = now
                alert = dict(tenant=tenant, burn_short=burn_short,
                             burn_long=burn_long,
                             threshold=pol.burn_alert,
                             window_s=pol.window_s,
                             short_window_s=pol.short_s,
                             budget_remaining=self._remaining(burn_long))
                fired.append(alert)
                if self.tracer is not None:
                    self.tracer.warning("slo_burn", **alert)
            if pol.autotune and admission is not None:
                self._autotune(tenant, st, pol, burn_long, admission)
        return fired

    def _autotune(self, tenant: str, st: _TenantBudget, pol: SLOPolicy,
                  burn_long: float, admission) -> None:
        """p99-vs-SLO feedback: sustained burn shrinks the tenant's
        effective queue depth (shed earlier, before overload queues into
        latency); a healthy burn decays the scale back toward 1.0."""
        scale = st.depth_scale
        if burn_long >= pol.burn_alert:
            scale = max(pol.min_depth_scale, scale * 0.5)
            if scale != st.depth_scale:
                st.depth_shrinks += 1
        elif burn_long <= pol.relax_burn and scale < 1.0:
            scale = min(1.0, scale * 1.5)
            st.depth_relaxes += 1
        if scale != st.depth_scale:
            st.depth_scale = scale
            admission.set_depth_scale(tenant, scale)

    @staticmethod
    def _remaining(burn_long: float) -> float:
        """Window budget left at the current long burn (1.0 = untouched,
        0.0 = exhausted)."""
        return max(0.0, 1.0 - burn_long)

    # -------------------------------------------------------------- state ---
    def snapshot(self, now: float) -> dict:
        tenants = {}
        for tenant in sorted(self._policies):
            pol = self._policies[tenant]
            st = self._tenants.get(tenant)
            burn_long = self.burn_rate(tenant, pol.window_s, now)
            burn_short = self.burn_rate(tenant, pol.short_s, now)
            tenants[tenant] = dict(
                target_p99_ms=(None if math.isinf(pol.target_p99_ms)
                               else pol.target_p99_ms),
                availability=pol.availability,
                window_s=pol.window_s,
                good=(st.good if st else 0),
                bad=(st.bad if st else 0),
                burn_short=burn_short,
                burn_long=burn_long,
                budget_remaining=self._remaining(burn_long),
                alerts=(st.alerts if st else 0),
                depth_scale=(st.depth_scale if st else 1.0),
                depth_shrinks=(st.depth_shrinks if st else 0),
                depth_relaxes=(st.depth_relaxes if st else 0),
            )
        return dict(tenants=tenants)
