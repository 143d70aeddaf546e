"""Halo (shard-boundary) row exchange (reference:
``repro/serve/sharded/halo.py``).

* :func:`gather_rows` — host loopback: assemble requested global rows from
  per-shard row blocks (the routed serve path's feature and factorization
  gathers).
* :class:`MeshHaloPlan` / :func:`build_mesh_plan` / :func:`ring_perms` —
  the static send/receive schedule of the ring exchange: pure bookkeeping,
  part of the ``routing.json`` sidecar and of ``ShardPlan.spmd_plan()``.
* :func:`ring_scatter` / :func:`mesh_exchange` — the ring exchange over the
  ranks of a ``torch.distributed`` group (one rank a shard): for each shift
  ``d = 1..P-1`` rank ``t`` sends exactly the rows rank ``(t+d) % P`` asked
  of it (the reference's ``ppermute`` ring), through the group's backend
  (:mod:`repro_torch.distributed.collectives`: nccl moves device tensors,
  gloo stages them through pinned host memory). When the payload is
  bit-packed (GCN "bin" layer 1) the words on the wire are the 32x smaller
  representation.

Byte accounting is explicit (:class:`HaloStats`): the loopback records the
rows it serves across shards, the ring transports the static schedule's
``payload_bytes`` once per exchange, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ...distributed import collectives
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


def ring_scatter(x_block: torch.Tensor, send_idx, recv_pos, n_buf: int,
                 group) -> torch.Tensor:
    """This rank's halo operand from the ring exchange over ``group``.

    ``x_block``: this rank's (n_local_pad, F) operand; ``send_idx`` /
    ``recv_pos``: this rank's row of each shift's schedule (one (m_d,)
    index tensor a shift, on ``x_block``'s device). Returns the (n_buf, F)
    halo operand: rows in ``halo_nodes`` order, padded rows zero, the
    overflow slot at ``n_buf`` (where schedule padding lands) sliced
    off."""
    halo = x_block.new_zeros((n_buf + 1,) + tuple(x_block.shape[1:]))
    got = collectives.ring_exchange([x_block[s] for s in send_idx], group)
    for rpos, recv in zip(recv_pos, got):
        halo[rpos] = recv
    return halo[:n_buf]


def schedule_row(table, r: int, device) -> list:
    """Rank ``r``'s row of each shift's (P, m_d) schedule array, as index
    tensors on ``device``."""
    return [torch.from_numpy(a[r].astype(np.int64)).to(device)
            for a in table]


def mesh_exchange(mesh, blocks, plan: MeshHaloPlan,
                  stats: Optional[HaloStats] = None,
                  tag: str = "halo") -> list:
    """The ring halo exchange over the mesh's ``data`` axis, which must
    span exactly ``plan.n_shards`` ranks. Every rank passes the P blocks
    (``blocks[s]``: shard ``s``'s rows, numpy or tensors) and sends the
    rows of its own; an all-gather of the padded halos then gives every
    rank the per-shard halo blocks (shard ``s``'s rows of every remote
    node it references, in ``halo_nodes[s]`` order), as numpy where the
    blocks were. Packed ``uint32`` words travel as their int32 bits."""
    group = mesh.get_group("data")
    p = plan.n_shards
    if dist.get_world_size(group) != p:
        raise ValueError(f"mesh_exchange over {dist.get_world_size(group)} "
                         f"ranks for {p} shards")
    r = dist.get_rank(group)
    host = isinstance(blocks[r], np.ndarray)
    x = blocks[r]
    dtype = np.dtype(x.dtype) if host else None
    if host:
        x = np.ascontiguousarray(x)
        x = torch.from_numpy(x.view(np.int32) if dtype == np.uint32 else x)
    dev = x.device
    halo = ring_scatter(x, schedule_row(plan.send_idx, r, dev),
                        schedule_row(plan.recv_pos, r, dev), plan.buf_rows,
                        group)
    halos = collectives.all_gather(halo, group)
    if stats is not None:
        stats.add(tag, plan.payload_bytes(int(x.shape[1]),
                                          x.element_size()))
    out = [h[:plan.halo_sizes[s]] for s, h in enumerate(halos)]
    if host:
        out = [o.numpy().view(dtype) for o in out]
    return out

