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

The port's mesh paths run one process a rank: :func:`run_ranks` starts
such a world, each rank over one device. :func:`make_shard_mesh` lays the
sharded serving path's 1-D ``("data",)`` mesh over it (the SPMD executor,
a shard a rank); :func:`make_host_mesh` lays the ("data", "model") mesh
of the LM paths (the expert-parallel MoE, ``Trainer(shardings=)``).
"""
from __future__ import annotations

import contextlib
import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

POLL_S = 0.05   # how often run_ranks looks at its ranks
# After the first rank exits non-zero, how long run_ranks waits for the
# others to go down before it names the rank that failed first.
GRACE_S = 5.0


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


def _rank_main(fn, rank: int, n: int, args: tuple, backend: str,
               device: str, root: str) -> None:
    """One rank of :func:`run_ranks`: its result, or its traceback, goes
    to ``<root>/rank<r>.pkl``; an error exits non-zero."""
    def error():     # stamped when raised, before the group goes down
        return ("error", traceback.format_exc(), time.time())

    out = None
    try:
        torch.set_num_threads(1)
        if device.startswith("cuda"):
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(root, "store"), n),
            rank=rank, world_size=n)
        try:
            out = ("ok", fn(rank, *args))
        except BaseException:
            out = error()
        dist.destroy_process_group()
    except BaseException:
        if out is None or out[0] == "ok":    # keep fn's own error
            out = error()
    ok = out[0] == "ok"
    tmp = os.path.join(root, f"rank{rank}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(out, f)
    os.replace(tmp, os.path.join(root, f"rank{rank}.pkl"))
    if not ok:
        os._exit(1)


def run_ranks(fn, n: int, *args, backend: str = "gloo",
              device: str = "cuda", timeout_s: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` on ``n`` rank processes of one new world
    and return their results in rank order.

    This is what takes the place of the reference's
    ``ensure_host_devices``: XLA gives one process ``n`` host devices,
    torch gives ``n`` processes one device each. The ranks are started with
    ``spawn`` (``fn`` and ``args`` are pickled, so ``fn`` lives at module
    level), each with one intra-op thread and ``device`` as its current
    device, and open the ``backend`` group over a ``dist.FileStore`` in a
    fresh temporary directory (no port to collide on). On the card the
    parent builds the kernels first, so the ranks do not compile them at
    once. A rank that raises, exits non-zero or runs past ``timeout_s``
    ends them all: the error names the rank whose error was stamped
    first, once the world is down or ``GRACE_S`` has passed, and carries
    its traceback; no partial result is returned."""
    import torch.multiprocessing as mp

    if device.startswith("cuda"):
        from ..kernels import build
        build.build_all()
    ctx = mp.get_context("spawn")
    root = tempfile.mkdtemp(prefix="ranks-")
    procs = []
    try:
        for r in range(n):
            pr = ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, n, args, backend, device, root))
            pr.start()
            procs.append(pr)
        return _gather(procs, root, timeout_s)
    finally:
        for pr in procs:
            if pr.is_alive():
                pr.kill()
            pr.join()
        shutil.rmtree(root, ignore_errors=True)


def _gather(procs, root: str, timeout_s: float) -> list:
    """The results of the ranks ``procs`` (anything with ``exitcode`` and
    ``is_alive()``) in rank order, read from ``root`` once every rank has
    exited 0; raises at the first rank to exit non-zero, or after
    ``timeout_s``."""
    n = len(procs)
    deadline = time.monotonic() + timeout_s
    while any(pr.is_alive() for pr in procs) \
            and _failed(procs) is None and time.monotonic() < deadline:
        time.sleep(POLL_S)
    if _failed(procs) is not None:
        _raise_first(procs, root)
    late = [r for r, pr in enumerate(procs) if pr.is_alive()]
    if late:
        raise TimeoutError(f"ranks {late} of {n} still running after "
                           f"{timeout_s} s")
    results = [_read_rank(root, r) for r in range(n)]
    missing = [r for r, res in enumerate(results) if res is None]
    if missing:
        raise RuntimeError(f"ranks {missing} of {n} exited without a "
                           f"result")
    return [res[1] for res in results]


def _failed(procs):
    """The lowest rank that exited non-zero, or None."""
    return next((r for r, pr in enumerate(procs)
                 if pr.exitcode not in (None, 0)), None)


def _raise_first(procs, root: str) -> None:
    """Raise for the rank that failed first. A rank that dies takes the
    collectives of the others down with it, and which of them exits first
    is a race: so wait until every rank has exited, or ``GRACE_S`` has
    passed, then name the earliest error stamp of every rank that wrote
    one, exited or not. A rank that exited non-zero without a result
    (killed, or crashed in C) comes after every stamp."""
    end = time.monotonic() + GRACE_S
    while any(pr.is_alive() for pr in procs) and time.monotonic() < end:
        time.sleep(POLL_S)
    res = {r: _read_rank(root, r) for r in range(len(procs))}
    errors = {r: out for r, out in res.items()
              if out is not None and out[0] == "error"}
    failed = [r for r, pr in enumerate(procs)
              if r in errors or pr.exitcode not in (None, 0)]
    first = min(failed, key=lambda r: errors[r][2] if r in errors
                else float("inf"))
    code = procs[first].exitcode
    tb = f":\n{errors[first][1]}" if first in errors else ""
    others = [r for r in failed if r != first]
    raise RuntimeError(
        f"rank {first} of {len(procs)} failed ("
        + (f"exit code {code}" if code is not None else "still running")
        + ")" + (f"; ranks {others} failed after it" if others else "") + tb)


def _read_rank(root: str, r: int):
    path = Path(root) / f"rank{r}.pkl"
    if not path.exists():
        return None
    with open(path, "rb") as f:
        return pickle.load(f)
