"""The collectives of the sharded serving path and the 1-bit all-reduce,
over ``torch.distributed`` (the reference's ``ppermute`` / ``all_gather``
inside ``shard_map``).

The transport follows the group's backend (``dist.get_backend``):

* ``"nccl"`` moves device tensors; a host tensor is refused;
* ``"gloo"`` moves host tensors: a device tensor is staged through pinned
  host memory on its way out and copied back to its device on its way in,
  and :func:`staged_bytes` counts the bytes staged either way (0 where the
  tensors already live on the host);
* any other backend raises.

Nothing falls back to another transport. Every rank of the group calls
each function with the same shapes, in the same order.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_STAGED = [0]


def staged_bytes() -> int:
    """Bytes this process staged through host memory for gloo."""
    return _STAGED[0]


def reset_staged() -> None:
    _STAGED[0] = 0


def backend(group) -> str:
    """The group's backend, one of :data:`BACKENDS`."""
    name = str(dist.get_backend(group))
    if name not in BACKENDS:
        raise ValueError(f"no transport over backend {name!r}; have "
                         f"{BACKENDS}")
    return name


def _wire(t: torch.Tensor, name: str) -> torch.Tensor:
    """``t`` as the backend sends it."""
    t = t.contiguous()
    if name == "nccl":
        if not t.is_cuda:
            raise ValueError("nccl moves device tensors; got one on "
                             f"{t.device}")
        return t
    if not t.is_cuda:
        return t
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    _STAGED[0] += t.numel() * t.element_size()
    return buf


def _recv_buf(like: torch.Tensor, name: str) -> torch.Tensor:
    """A buffer the backend receives ``like``'s shape and dtype into."""
    if name == "gloo" and like.is_cuda:
        return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
    return torch.empty(like.shape, dtype=like.dtype, device=like.device)


def _home(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A received tensor on ``like``'s device."""
    if t.device == like.device:
        return t
    _STAGED[0] += t.numel() * t.element_size()
    return t.to(like.device)


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on all ranks), in group rank order,
    on ``t``'s device."""
    name = backend(group)
    x = _wire(t, name)
    out = [_recv_buf(t, name) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, x, group=group)
    return [_home(o, t) for o in out]


def ring_exchange(payloads: Sequence[torch.Tensor], group
                  ) -> List[torch.Tensor]:
    """The P-1 ring shifts in one batch: ``payloads[d-1]`` goes to group
    rank ``(r+d) % P``, and entry ``d-1`` of the result is what rank
    ``(r-d) % P`` sent in shift ``d``. Each shift's payload has one shape
    on every rank; each ordered pair of ranks carries one message."""
    name = backend(group)
    p = dist.get_world_size(group)
    r = dist.get_rank(group)
    if len(payloads) != p - 1:
        raise ValueError(f"{len(payloads)} payloads for {p - 1} shifts")
    ops, bufs = [], []
    for d, t in enumerate(payloads, start=1):
        buf = _recv_buf(t, name)
        ops.append(dist.P2POp(dist.isend, _wire(t, name),
                              dist.get_global_rank(group, (r + d) % p),
                              group))
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, (r - d) % p),
                              group))
        bufs.append(buf)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return [_home(b, t) for b, t in zip(bufs, payloads)]
