"""Halo (shard-boundary) row exchange (reference:
``repro/serve/sharded/halo.py``).

* :func:`gather_rows` — host loopback: assemble requested global rows from
  per-shard row blocks (the routed serve path's feature and factorization
  gathers).
* :class:`MeshHaloPlan` / :func:`build_mesh_plan` / :func:`ring_perms` —
  the static send/receive schedule of the ring exchange: pure bookkeeping,
  part of the ``routing.json`` sidecar and of ``ShardPlan.spmd_plan()``.

The ring transport over devices (the reference's ``ring_scatter`` and
``mesh_exchange``, ``shard_map``/``ppermute``) comes with the SPMD executor
(ROADMAP Queue 1 item 5, over ``torch.distributed``). Byte accounting is
explicit (:class:`HaloStats`): the host executor records the same bytes
under the same tags as the reference's loopback.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .routing import RoutingTable


class HaloStats:
    """Per-tag byte counters for cross-shard row movement."""

    def __init__(self) -> None:
        self.bytes_by_tag: Dict[str, int] = {}
        self.events = 0

    def add(self, tag: str, nbytes: int) -> None:
        self.bytes_by_tag[tag] = self.bytes_by_tag.get(tag, 0) + int(nbytes)
        self.events += 1

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_tag.values())

    def snapshot(self) -> dict:
        return dict(total_bytes=self.total_bytes, events=self.events,
                    by_tag=dict(self.bytes_by_tag))


def gather_rows(blocks: List[np.ndarray], routing: RoutingTable,
                nodes: np.ndarray, home: Optional[int] = None,
                stats: Optional[HaloStats] = None,
                tag: str = "halo") -> np.ndarray:
    """Assemble rows ``nodes`` (global ids, any order) from per-shard row
    blocks. Rows served by a shard other than ``home`` count as halo traffic.
    Works for any trailing shape/dtype (fp features, packed uint32 words,
    1-D factorization vectors)."""
    nodes = np.asarray(nodes, np.int64)
    owner = routing.owner(nodes)
    first = np.asarray(blocks[0])
    out = np.empty((nodes.size,) + first.shape[1:], first.dtype)
    for s in range(routing.n_shards):
        sel = np.nonzero(owner == s)[0]
        if sel.size == 0:
            continue
        rows = np.asarray(blocks[s])[nodes[sel] - routing.bounds[s]]
        out[sel] = rows
        if stats is not None and s != home:
            stats.add(tag, rows.nbytes)
    return out


# ---------------------------------------------------------------------------
# The ring exchange's schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MeshHaloPlan:
    """Static send/receive schedule of the ring exchange.

    ``send_idx[d-1]``: (P, m_d) local row ids shard ``t`` sends to shard
    ``(t+d) % P`` (padded with 0 — masked out by the receiver's positions).
    ``recv_pos[d-1]``: (P, m_d) positions in the RECEIVER's halo buffer
    (padded with ``n_halo_buf``, an overflow slot sliced off afterwards).

    ``n_halo_buf`` is the receive-buffer row count — ``n_halo_max`` by
    default, or the SPMD executor's uniform tile-aligned halo pad.

    ``payload_bytes`` is the byte-accounting source for every transport that
    runs this schedule: a pure function of the static plan.
    """
    n_shards: int
    n_halo_max: int
    halo_sizes: List[int]
    send_idx: List[np.ndarray]
    recv_pos: List[np.ndarray]
    n_halo_buf: Optional[int] = None

    @property
    def buf_rows(self) -> int:
        return self.n_halo_max if self.n_halo_buf is None else self.n_halo_buf

    def payload_bytes(self, width: int, itemsize: int) -> int:
        """Wire bytes of one exchange (padded payloads included)."""
        return sum(int(si.size) * width * itemsize for si in self.send_idx)

    def to_json(self) -> dict:
        return dict(n_shards=self.n_shards, n_halo_max=self.n_halo_max,
                    n_halo_buf=self.buf_rows, halo_sizes=self.halo_sizes,
                    send_idx=[si.tolist() for si in self.send_idx],
                    recv_pos=[rp.tolist() for rp in self.recv_pos])

    @classmethod
    def from_json(cls, d: dict) -> "MeshHaloPlan":
        return cls(n_shards=int(d["n_shards"]),
                   n_halo_max=int(d["n_halo_max"]),
                   halo_sizes=[int(h) for h in d["halo_sizes"]],
                   send_idx=[np.asarray(a, np.int32) for a in d["send_idx"]],
                   recv_pos=[np.asarray(a, np.int32) for a in d["recv_pos"]],
                   n_halo_buf=int(d["n_halo_buf"]))


def build_mesh_plan(routing: RoutingTable, halo_nodes: List[np.ndarray],
                    n_halo_buf: Optional[int] = None) -> MeshHaloPlan:
    p = routing.n_shards
    n_halo_max = max([h.size for h in halo_nodes] + [1])
    buf = n_halo_max if n_halo_buf is None else int(n_halo_buf)
    if buf < n_halo_max:
        raise ValueError(f"n_halo_buf {buf} < n_halo_max {n_halo_max}")
    send_idx, recv_pos = [], []
    for d in range(1, p):
        pair_send, pair_recv = [], []
        for t in range(p):                       # sender t -> receiver s
            s = (t + d) % p
            h = halo_nodes[s]
            lo, hi = routing.shard_range(t)
            m = (h >= lo) & (h < hi)
            pair_send.append(h[m] - lo)
            pair_recv.append(np.nonzero(m)[0])
        width = max([a.size for a in pair_send] + [1])
        si = np.zeros((p, width), np.int32)
        rp = np.full((p, width), buf, np.int32)           # overflow slot
        for t in range(p):
            si[t, :pair_send[t].size] = pair_send[t]
            s = (t + d) % p
            rp[s, :pair_recv[t].size] = pair_recv[t]
        send_idx.append(si)
        recv_pos.append(rp)
    return MeshHaloPlan(n_shards=p, n_halo_max=n_halo_max,
                        halo_sizes=[int(h.size) for h in halo_nodes],
                        send_idx=send_idx, recv_pos=recv_pos,
                        n_halo_buf=buf)


def ring_perms(p: int) -> List[List[tuple]]:
    """The P-1 ring-shift permutations of the exchange (shift d sends
    shard t's payload to shard (t+d) % P)."""
    return [[(t, (t + d) % p) for t in range(p)] for d in range(1, p)]
