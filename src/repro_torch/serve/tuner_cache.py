"""Persistent BSpMM tuner cache (reference: ``repro/serve/tuner_cache.py``).

A block-shape sweep's measurements persist as JSON. Each MEASUREMENT is one
entry keyed by ``(graph stats fingerprint, block shape, backend, fused
flag)``; a lookup returns the fastest recorded block for a (fingerprint,
backend, fused) triple, which :class:`repro_torch.serve.gnn_session
.GraphStore` uses to seed ``SessionPlan.bspmm_block`` when the store has no
explicit block. The backend tag is the device type the measurement ran on,
``"cuda"`` or ``"cpu"``.

File format (``schema`` guards layout changes; unknown schemas are ignored,
not migrated)::

    {"schema": 1,
     "entries": {
       "<fp12>|cuda|fused=0|blk=8x128": {
         "stats": {"n_nodes": ..., "n_edges": ..., "n_feat": ...},
         "backend": "cuda", "fused": false,
         "block": [8, 128],        # null = the 1D kernels
         "latency_s": 1.3e-4}}}

The fingerprint hashes the graph's aggregate STATS, not its topology.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Optional, Tuple

import torch

SCHEMA = 1


def default_backend() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def graph_stats(data) -> dict:
    """The aggregate stats a block-shape choice depends on."""
    return dict(n_nodes=int(data.n_nodes), n_edges=int(data.n_edges),
                n_feat=int(data.x.shape[1]))


def stats_fingerprint(stats: dict) -> str:
    canon = json.dumps(stats, sort_keys=True).encode()
    return hashlib.sha1(canon).hexdigest()[:12]


def _block_tag(block) -> str:
    return "default" if block is None else f"{block[0]}x{block[1]}"


def entry_key(stats: dict, block, backend: str, fused: bool) -> str:
    return (f"{stats_fingerprint(stats)}|{backend}|fused={int(fused)}"
            f"|blk={_block_tag(block)}")


class TunerCache:
    """JSON-file-backed measurement store, written through on record."""

    def __init__(self, path):
        self.path = Path(path)
        self.entries: dict = {}
        if self.path.exists():
            try:
                doc = json.loads(self.path.read_text())
            except (OSError, json.JSONDecodeError):
                doc = {}
            if isinstance(doc, dict) and doc.get("schema") == SCHEMA:
                self.entries = doc.get("entries", {})

    def _flush(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(
            {"schema": SCHEMA, "entries": self.entries},
            indent=1, sort_keys=True))

    def record(self, stats: dict, block, latency_s: float,
               fused: bool = False, backend: Optional[str] = None) -> str:
        """Store one measurement (overwrites a re-measured key) and flush."""
        backend = backend or default_backend()
        key = entry_key(stats, block, backend, fused)
        self.entries[key] = dict(
            stats=stats, backend=backend, fused=bool(fused),
            block=None if block is None else list(block),
            latency_s=float(latency_s))
        self._flush()
        return key

    def lookup(self, stats: dict, fused: bool = False,
               backend: Optional[str] = None
               ) -> Optional[Tuple[int, int]]:
        """Fastest recorded block shape for this (stats, backend, fused)
        triple; None when nothing is recorded OR the 1D kernels were the
        fastest measurement."""
        backend = backend or default_backend()
        fp = stats_fingerprint(stats)
        best, best_lat = None, None
        for e in self.entries.values():
            if (stats_fingerprint(e["stats"]) != fp
                    or e["backend"] != backend
                    or bool(e["fused"]) != bool(fused)):
                continue
            if best_lat is None or e["latency_s"] < best_lat:
                best_lat = e["latency_s"]
                best = e["block"]
        return None if best is None else tuple(best)
