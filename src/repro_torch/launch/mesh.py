"""Device meshes (reference: ``repro/launch/mesh.py``).

Single pod: (16, 16) = 256 cards, axes ("data", "model"). Multi-pod:
(2, 16, 16) = 512 cards with a leading "pod" axis (pure data parallelism
across pods). A ``DeviceMesh`` needs a process group with one rank a card;
the reference's dry run instead lays its mesh over 512 placeholder devices
of one process. :func:`make_production_mesh` does the same over a fake
process group (``torch.testing._internal.distributed.fake_pg``: every
collective returns at once and moves nothing), opened only inside its
``with`` block and destroyed on exit, so a dry run leaves
``dist.is_initialized()`` as it found it and no engine, trainer or test in
the same process sees the group. Nothing here touches a device or a
process group when the module is imported.

The reference's ``ensure_host_devices`` (more XLA host devices for its SPMD
shard executor) has no caller in the port yet: the executor over
``torch.distributed`` is ROADMAP Queue 1 item 3.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


@contextlib.contextmanager
def _world(size: int, backend: str):
    """The default process group of ``size`` ranks: the open one if it has
    that size; else a new one with this process as rank 0 (``backend``
    "fake" or "gloo", over an in-process store), destroyed on exit."""
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is open; "
                f"this mesh needs {size}")
        yield
        return
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _card_type() -> str:
    """"cuda" where the process has a card; else "cpu", as DTensor cannot
    work out some ops' shapes on CUDA tensors without CUDA (it then also
    replaces an all-to-all by an all-gather)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _mesh(device_type: str, shape, axes) -> DeviceMesh:
    return DeviceMesh(device_type,
                      torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False):
    """``with make_production_mesh() as mesh:`` the (16, 16) ("data",
    "model") mesh of cards, or (2, 16, 16) with "pod" in front. Over
    the open process group where it has 256 (512) ranks, else over a fake
    one for the ``with`` block (a dry run: tensors on the meta device)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    with _world(math.prod(shape), "fake"):
        yield _mesh(_card_type(), shape, axes)


@contextlib.contextmanager
def make_host_mesh(model: int = 1, device: str = "cuda"):
    """``with make_host_mesh() as mesh:`` a (data, model) mesh over the
    local ranks, one device each (the card unless ``device="cpu"``): the
    open process group's, or this process alone in a one-rank gloo group
    for the ``with`` block."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = max(n // model, 1)
    with _world(data * model, "gloo"):
        yield _mesh(device, (data, model), ("data", "model"))


def make_shard_mesh(n_shards: int):
    """A mesh with a ``data`` axis of exactly ``n_shards`` ranks of the
    open process group, the shape the sharded serving halo exchange runs
    over; None when fewer ranks are open (callers fall back to the host
    loopback transport)."""
    if not dist.is_initialized() or dist.get_world_size() < n_shards:
        return None
    return DeviceMesh(_card_type(), list(range(n_shards)),
                      mesh_dim_names=("data",))


def dp_axes(mesh: DeviceMesh):
    """The data-parallel mesh axes (includes "pod" when present)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)
