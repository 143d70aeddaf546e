"""Per-query cost model for the GNN serving path (reference:
``repro/serve/cost.py``, copied).

The serving stack charges every submission one admission token and only
reports latency after the fact; but a k-hop hub-node query costs orders of
magnitude more service time than a leaf hit on the full cache. This module
predicts that cost at SUBMIT time from host-side statics — quantities that
are pure functions of the graph topology and the static serving plans, so
estimation never touches a session or the device:

  * **k-hop closure size** via the CSR sampling index
    (:func:`repro_torch.graphs.sampling.khop_nodes`): the node/edge volume the
    extract stage must walk and the bucketed forward must aggregate;
  * **halo rows** from the static halo schedule (the sharded engine feeds
    the seed's remote-neighbor FRDC tiles — the same per-tile accounting
    :meth:`MeshHaloPlan.payload_bytes` uses for the distributed pass — so
    ``halo_bytes = rows * row_bytes`` is the ``serve/x`` gather this seed
    will request);
  * **bucket padding waste** from the pow2 bucket table
    (:func:`repro_torch.serve.session_core.bucket_pow2`): padded rows cost real
    device time even though no query asked for them.

Predicted units are CALIBRATED online against the measured per-batch
service time from the engine's trace spans (extract + de-overlapped device
compute): :meth:`CostEstimator.observe_batch` keeps a per-bucket EWMA of
cost-units-per-second, and :meth:`attribute` splits a batch's measured
seconds back across its member queries pro rata by predicted units — the
per-tenant cost attribution the metrics/Prometheus layers surface.

Everything here is numpy + stdlib; :func:`spearman_rho` (the
calibration-accuracy gauge: rank correlation between predicted and measured
per-batch cost) is implemented with average ranks so scipy is not needed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..graphs import sampling
from .session_core import bucket_pow2


def spearman_rho(x: Sequence[float], y: Sequence[float]) -> float:
    """Spearman rank correlation (average ranks for ties; numpy only).

    Returns NaN for fewer than 3 points or a constant series — callers gate
    on ``rho >= threshold`` so NaN reads as "not enough signal", never as a
    pass."""
    xa = np.asarray(x, np.float64)
    ya = np.asarray(y, np.float64)
    if xa.size != ya.size:
        raise ValueError(f"length mismatch: {xa.size} vs {ya.size}")
    if xa.size < 3:
        return float("nan")

    def _ranks(a: np.ndarray) -> np.ndarray:
        order = np.argsort(a, kind="stable")
        ranks = np.empty(a.size, np.float64)
        sa = a[order]
        i = 0
        while i < a.size:
            j = i
            while j + 1 < a.size and sa[j + 1] == sa[i]:
                j += 1
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0   # average rank
            i = j + 1
        return ranks

    rx, ry = _ranks(xa), _ranks(ya)
    sx, sy = rx.std(), ry.std()
    if sx == 0.0 or sy == 0.0:
        return float("nan")
    return float(np.mean((rx - rx.mean()) * (ry - ry.mean())) / (sx * sy))


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Predicted cost of one query, with its feature breakdown."""
    units: float                 # predicted cost units (>= 1)
    closure_nodes: int = 1
    closure_edges: int = 0
    halo_rows: int = 0
    halo_bytes: int = 0
    pad_nodes: int = 0           # pow2 bucket rows beyond the closure
    full_cache: bool = False

    def to_json(self) -> dict:
        return dict(units=self.units, closure_nodes=self.closure_nodes,
                    closure_edges=self.closure_edges,
                    halo_rows=self.halo_rows, halo_bytes=self.halo_bytes,
                    pad_nodes=self.pad_nodes, full_cache=self.full_cache)


class CostEstimator:
    """Submit-time cost prediction + online calibration.

    Estimates are DETERMINISTIC functions of the graph topology (feature
    updates never move them — topology is what :meth:`estimate` reads), and
    are cached per ``(graph, node)`` with bounded occupancy, mirroring the
    sharded engine's halo-signature cache.

    Unit weights are relative work factors, not seconds: a closure node is
    one feature-transform row, a closure edge a quarter-row of aggregation,
    a halo row half a row of DMA, a padded row a sliver of wasted device
    time. Calibration (:meth:`observe_batch`) maps units to seconds —
    per-bucket EWMAs of units-per-second — so the absolute scale of the
    weights washes out; only their ratios (and hence the predicted RANKING
    of queries) matter, which is what the Spearman gate checks.
    """

    NODE_UNIT = 1.0
    EDGE_UNIT = 0.25
    HALO_ROW_UNIT = 0.5
    PAD_UNIT = 0.05
    FULL_CACHE_UNITS = 1.0       # O(1): a row gather from the cached pass

    CACHE_MAX = 262_144

    def __init__(self, khop: int = 2, bucket_floor: int = 64,
                 ewma_alpha: float = 0.25, whale_factor: float = 8.0,
                 whale_units: Optional[float] = None,
                 history: int = 4096):
        if khop < 1:
            raise ValueError(f"khop must be >= 1, got {khop}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], "
                             f"got {ewma_alpha}")
        self.khop = int(khop)
        self.bucket_floor = int(bucket_floor)
        self.ewma_alpha = float(ewma_alpha)
        self.whale_factor = float(whale_factor)
        self.whale_units = whale_units   # explicit threshold wins over the
        #                                  traffic-relative whale_factor
        self._cache: Dict[Tuple[str, int, int, int], CostEstimate] = {}
        # typical per-query predicted units (EWMA over estimates issued) —
        # the denominator of the traffic-relative whale threshold
        self._unit_ewma: Optional[float] = None
        # calibration: per-bucket (n_pad) and overall units-per-second EWMAs
        self._rate_by_bucket: Dict[int, float] = {}
        self._rate_overall: Optional[float] = None
        self.batches_observed = 0
        self.queries_estimated = 0
        # bounded per-batch (predicted units, measured seconds) history —
        # the Spearman rank-correlation stream
        self._pred: List[float] = []
        self._meas: List[float] = []
        self._history = int(history)

    # ------------------------------------------------------------ predict ---
    def estimate(self, graph: str, node: int, csr: sampling.CSRGraph,
                 khop: Optional[int] = None, halo_rows: int = 0,
                 row_bytes: int = 0,
                 full_cache: bool = False) -> CostEstimate:
        """Predict one query's cost from host-side statics. ``csr`` is the
        graph's cached CSR index; ``halo_rows`` the remote feature rows the
        seed's halo signature requests (0 on the single-host path);
        ``full_cache=True`` short-circuits to the O(1) cached-pass cost."""
        if full_cache:
            est = CostEstimate(units=self.FULL_CACHE_UNITS, full_cache=True)
            self._note_estimate(est)
            return est
        k = self.khop if khop is None else int(khop)
        key = (graph, int(node), k, int(halo_rows))
        est = self._cache.get(key)
        if est is None:
            nodes = sampling.khop_nodes(csr, np.asarray([node], np.int64),
                                        k)
            n_closure = int(nodes.size)
            degs = csr.indptr[nodes + 1] - csr.indptr[nodes]
            n_edges = int(degs.sum())
            pad = bucket_pow2(max(n_closure, 1), self.bucket_floor) \
                - n_closure
            units = (self.NODE_UNIT * n_closure
                     + self.EDGE_UNIT * n_edges
                     + self.HALO_ROW_UNIT * halo_rows
                     + self.PAD_UNIT * pad)
            est = CostEstimate(units=max(units, 1.0),
                               closure_nodes=n_closure,
                               closure_edges=n_edges,
                               halo_rows=int(halo_rows),
                               halo_bytes=int(halo_rows) * int(row_bytes),
                               pad_nodes=int(pad))
            if len(self._cache) >= self.CACHE_MAX:
                self._cache.pop(next(iter(self._cache)))
            self._cache[key] = est
        self._note_estimate(est)
        return est

    def estimate_flat(self, units: float) -> CostEstimate:
        """Predict a query whose cost is already a unit count (the token
        engine's prompt+decode length) — no topology features, but the
        estimate still feeds the whale EWMA and calibration streams."""
        est = CostEstimate(units=max(float(units), 1.0))
        self._note_estimate(est)
        return est

    def _note_estimate(self, est: CostEstimate) -> None:
        self.queries_estimated += 1
        a = self.ewma_alpha
        self._unit_ewma = est.units if self._unit_ewma is None \
            else (1.0 - a) * self._unit_ewma + a * est.units

    def is_whale(self, est: Optional[CostEstimate]) -> bool:
        """Whether a query's predicted cost marks it as a whale the sharded
        formation should not co-batch with another whale. An explicit
        ``whale_units`` threshold is absolute; otherwise a whale costs
        ``whale_factor``x the typical (EWMA) query seen so far."""
        if est is None:
            return False
        if self.whale_units is not None:
            return est.units >= self.whale_units
        typical = max(self._unit_ewma or 1.0, 1.0)
        return est.units >= self.whale_factor * typical

    # -------------------------------------------------------- calibration ---
    def observe_batch(self, pred_units: float, measured_s: float,
                      n_pad: int = 0) -> None:
        """Fold one served batch into the calibration state: ``pred_units``
        the batch's summed predicted units, ``measured_s`` its measured
        service seconds (extract + de-overlapped device compute, from the
        batch's trace spans), ``n_pad`` the launched bucket (0 for a
        full-cache batch)."""
        if measured_s <= 0.0 or pred_units <= 0.0:
            return
        rate = pred_units / measured_s
        a = self.ewma_alpha
        cur = self._rate_by_bucket.get(int(n_pad))
        self._rate_by_bucket[int(n_pad)] = rate if cur is None \
            else (1.0 - a) * cur + a * rate
        self._rate_overall = rate if self._rate_overall is None \
            else (1.0 - a) * self._rate_overall + a * rate
        self.batches_observed += 1
        if len(self._pred) >= self._history:
            self._pred.pop(0)
            self._meas.pop(0)
        self._pred.append(float(pred_units))
        self._meas.append(float(measured_s))

    def attribute(self, units: Sequence[float],
                  measured_s: float) -> List[float]:
        """Split a batch's measured seconds across its queries pro rata by
        predicted units (equal shares when nothing was predicted)."""
        u = [max(float(v), 0.0) for v in units]
        total = sum(u)
        if total <= 0.0:
            n = max(len(u), 1)
            return [measured_s / n] * len(u)
        return [measured_s * v / total for v in u]

    def units_per_second(self, n_pad: Optional[int] = None
                         ) -> Optional[float]:
        if n_pad is not None and int(n_pad) in self._rate_by_bucket:
            return self._rate_by_bucket[int(n_pad)]
        return self._rate_overall

    def estimate_seconds(self, est: CostEstimate,
                         n_pad: Optional[int] = None) -> Optional[float]:
        """Predicted service seconds for one query (None before the first
        calibration sample)."""
        rate = self.units_per_second(n_pad)
        if rate is None or rate <= 0.0:
            return None
        return est.units / rate

    def predicted_vs_measured(self) -> Tuple[np.ndarray, np.ndarray]:
        """The per-batch (predicted units, measured seconds) history."""
        return (np.asarray(self._pred, np.float64),
                np.asarray(self._meas, np.float64))

    def rank_correlation(self, last: Optional[int] = None) -> float:
        """Spearman rho between predicted and measured per-batch cost over
        the (optionally truncated) calibration history."""
        p, m = self.predicted_vs_measured()
        if last is not None:
            p, m = p[-last:], m[-last:]
        return spearman_rho(p, m)

    def snapshot(self) -> dict:
        rho = self.rank_correlation()
        return dict(
            khop=self.khop,
            queries_estimated=self.queries_estimated,
            batches_observed=self.batches_observed,
            typical_units=self._unit_ewma,
            whale_threshold_units=(
                self.whale_units if self.whale_units is not None
                else self.whale_factor * max(self._unit_ewma or 1.0, 1.0)),
            units_per_second=self._rate_overall,
            units_per_second_by_bucket={
                str(k): v for k, v in sorted(self._rate_by_bucket.items())},
            rank_correlation=None if rho != rho else rho,
            cached_estimates=len(self._cache),
        )
