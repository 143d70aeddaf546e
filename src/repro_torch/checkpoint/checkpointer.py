"""Async checkpointing in the reference's on-disk layout (reference:
``repro/checkpoint/checkpointer.py``).

Layout per step: ``<dir>/step_<N>/shard_0.npz`` + ``manifest.json``
(written LAST: a checkpoint without a complete manifest is ignored, so a
save is atomic under a crash). Leaves are stored as numpy arrays under the
names ``a0, a1, ...`` and the manifest lists their tree paths. The paths are
the strings the reference derives from ``jax.tree_util
.tree_flatten_with_path``: dict keys sorted and written as they are,
NamedTuple fields as ``.<field>``, sequence items as their index; ``None``
holds no leaf. So a checkpoint written by either package lists the same
keys and restores in the other. Saves run on a background thread;
:meth:`Checkpointer.wait` joins it.

numpy has no bfloat16: the reference's ``np.savez`` writes a bf16 leaf as
a 2-byte void (``|V2``) holding its bits, and so does :meth:`save` here.
:meth:`Checkpointer.restore` turns such a leaf back into a bf16 tensor
where the matching leaf of ``like`` is bf16.

``restore(..., shardings=)`` re-places the leaves on a ``DeviceMesh`` (an
elastic restart on another mesh): each rank reads the saved global array
and keeps its own shard as a ``DTensor``.

A world of ranks saves one checkpoint: :meth:`Checkpointer.save` gathers
each ``DTensor`` leaf to its global array (``full_tensor()``, on the
calling thread, on every rank, in flatten order; the writer thread issues
no collective), and only rank 0 of the checkpointer's process group
writes, in the layout above, so a world's checkpoint restores in one
process and in the reference. The group is the one given, or the default
group where a saved state holds ``DTensor`` leaves. With a group,
:meth:`wait` ends with its barrier and :meth:`latest_step` is rank 0's
answer on every rank. With no group and no ``DTensor`` leaves nothing
changes: every process writes its own checkpoint.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(tree):
    """(key string, child) pairs of a tree node in flatten order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree: Any) -> Tuple[List[str], list, Any]:
    """(path keys, leaves, tree structure) in the reference's order."""
    keys, leaves = [], []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            keys.append("/".join(path))
            leaves.append(node)
            return
        for k, v in kids:
            walk(v, path + [k])

    walk(tree, [])
    return keys, leaves, tree


def _unflatten(structure: Any, leaves: list) -> Any:
    """Rebuild ``structure`` with its leaves replaced, in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(structure)


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:   # the bits, as a 2-byte void
            return leaf.view(torch.int16).numpy().view(np.dtype("V2"))
        return leaf.numpy()
    return np.asarray(leaf)


def _from_host(stored: np.ndarray, like_leaf):
    """A stored array as :meth:`Checkpointer.restore` returns it: a bf16
    tensor for a 2-byte void under a bf16 leaf of ``like``, else itself."""
    if stored.dtype.kind != "V":
        return stored
    if stored.dtype.itemsize != 2 or not (
            isinstance(like_leaf, torch.Tensor)
            and like_leaf.dtype == torch.bfloat16):
        raise ValueError(f"a stored {stored.dtype} leaf restores only into "
                         f"a bfloat16 leaf, not {type(like_leaf).__name__}")
    return torch.from_numpy(stored.view(np.int16).copy()).view(
        torch.bfloat16)


def _is_dtensor(x) -> bool:
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


class Checkpointer:
    def __init__(self, directory, keep: int = 3, group=None):
        """``group``: the process group whose ranks save one checkpoint
        together (rank 0 writes); None for a checkpointer of its own."""
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.group = group
        self._thread: Optional[threading.Thread] = None

    def _rank(self) -> int:
        import torch.distributed as dist
        return dist.get_rank(self.group)

    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        self.wait()
        keys, leaves, _ = _flatten(state)
        if any(_is_dtensor(x) for x in leaves):
            if self.group is None:
                import torch.distributed as dist
                self.group = dist.group.WORLD
            # every rank gathers, here, in flatten order
            leaves = [x.full_tensor() if _is_dtensor(x) else x
                      for x in leaves]
        if self.group is not None and self._rank() != 0:
            if blocking:
                self.wait()
            return
        # device -> host copy happens here (a consistent view); the writes
        # happen on the thread
        host_leaves = [_host(x) for x in leaves]

        def _write():
            out = self.dir / f"step_{step:08d}"
            out.mkdir(parents=True, exist_ok=True)
            np.savez(out / "shard_0.npz",
                     **{f"a{i}": v for i, v in enumerate(host_leaves)})
            manifest = {"step": step, "time": time.time(), "keys": keys,
                        "n_leaves": len(host_leaves),
                        "shards": ["shard_0.npz"]}
            (out / "manifest.json").write_text(json.dumps(manifest))
            self._gc()

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.group is not None:      # rank 0's files are on disk
            import torch.distributed as dist
            dist.barrier(group=self.group)

    def _complete(self) -> list:
        return sorted(p for p in self.dir.glob("step_*")
                      if (p / "manifest.json").exists())

    def _gc(self) -> None:
        for old in self._complete()[: -self.keep]:
            for f in old.glob("*"):
                f.unlink()
            old.rmdir()

    def latest_step(self) -> Optional[int]:
        if self.group is not None:      # rank 0's answer on every rank
            import torch.distributed as dist
            got = [self._latest() if self._rank() == 0 else None]
            dist.broadcast_object_list(
                got, src=dist.get_global_rank(self.group, 0),
                group=self.group)
            return got[0]
        return self._latest()

    def _latest(self) -> Optional[int]:
        done = self._complete()
        if not done:
            return None
        return int(done[-1].name.split("_")[1])

    def restore(self, step: Optional[int], like: Any,
                shardings: Any = None) -> Any:
        """Restore into the structure of ``like``; leaves come back as numpy
        arrays with the stored dtypes, and a stored bf16 leaf (a 2-byte
        void) as a bf16 CPU tensor where ``like``'s leaf is bf16.

        ``shardings``: ``like``'s structure with ``(mesh, placements)``
        leaves (the placements as ``distributed.sharding.placements``
        gives them); each leaf then comes back as a ``DTensor`` on that
        mesh holding this rank's slice of the saved global array."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {self.dir}")
        out = self.dir / f"step_{step:08d}"
        manifest = json.loads((out / "manifest.json").read_text())
        data = np.load(out / manifest["shards"][0])
        leaves = [data[f"a{i}"] for i in range(manifest["n_leaves"])]
        keys, like_leaves, structure = _flatten(like)
        if keys != manifest["keys"]:
            raise ValueError("checkpoint/model structure mismatch")
        leaves = [_from_host(v, l) for v, l in zip(leaves, like_leaves)]
        if shardings is not None:
            places = _sharding_leaves(shardings)
            if len(places) != len(leaves):
                raise ValueError(f"{len(places)} shardings for "
                                 f"{len(leaves)} leaves")
            leaves = [_place(v, *pl) for v, pl in zip(leaves, places)]
        return _unflatten(structure, leaves)


def _sharding_leaves(tree) -> list:
    """The ``(mesh, placements)`` leaves of a shardings tree, in flatten
    order."""
    from torch.distributed.device_mesh import DeviceMesh

    out = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, tuple) and len(node) == 2 \
                and isinstance(node[0], DeviceMesh):
            out.append(node)
            return
        kids = _children(node)
        if kids is None:
            raise ValueError(f"a shardings leaf is (mesh, placements), not "
                             f"{type(node).__name__}")
        for _, v in kids:
            walk(v)

    walk(tree)
    return out


def _place(value, mesh, placements):
    """This rank's slice of the global ``value`` as a DTensor on ``mesh``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    full = value if isinstance(value, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(value))
    shape, offset = compute_local_shape_and_global_offset(
        full.shape, mesh, placements)
    local = full[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    return DTensor.from_local(local.contiguous().to(mesh.device_type), mesh,
                              placements, run_check=False,
                              shape=full.shape, stride=full.stride())
