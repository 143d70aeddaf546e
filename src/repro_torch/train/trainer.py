"""Fault-tolerant training loop: periodic async checkpoints, crash-restart
recovery and failure injection for tests (reference:
``repro/train/trainer.py``).

The recovery contract: a Trainer constructed over the same checkpoint dir
resumes from the newest COMPLETE manifest (atomic saves). The data stream
comes from the loader it is given, and a fresh loader replays its seed's
stream from the first batch (``data.pipeline``). ``FailureInjector``
raises at a chosen step to exercise the path, the exception surface of a
preempted worker; :func:`run_with_restarts` is the outer loop that
restarts the trainer.

The reference jits the step with its state buffers donated; here the step
runs eagerly and the loop rebinds the state it returns. Batches go to
``device`` as the loader's int32 index tensors. A restore places the
checkpoint's leaves on ``device`` in their stored dtypes, as the
reference's ``jnp.asarray`` does (``AdamWState.step`` a 0-d int32
tensor).

``shardings`` (an elastic re-mesh on restore, as in the reference): a tree
of ``(mesh, placements)`` leaves over ``(params, opt_state, extra)``
(``distributed.sharding.param_shardings`` / ``opt_shardings``). A restore
re-places the state under it; a fresh start runs the state ``init_state``
returns. Where the state holds DTensors, each step's batch goes in as a
DTensor sharded over the data axes (``sharding.data_shardings``), the
loss is read replicated, and every leaf must keep its placements from
step to step (the train step moves each gradient to its parameter's
placements; a leaf that drifts raises). In a world of ranks (one process
a rank, ``launch.mesh.run_ranks``), every rank makes every call in one
order: rank 0's batch and straggler misses are broadcast, so every rank
steps on the same global batch, and the checkpointer writes once (rank 0)
and agrees on the latest step (``checkpoint.checkpointer``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..checkpoint.checkpointer import Checkpointer
from ..data.pipeline import PrefetchLoader


class InjectedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FailureInjector:
    fail_at_step: int = -1
    fired: bool = False

    def maybe_fail(self, step: int):
        if step == self.fail_at_step and not self.fired:
            self.fired = True
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    compress_grads: bool = False


def _to_device(tree: Any, device) -> Any:
    """A restored tree (numpy arrays, bf16 tensors) on ``device``, each
    leaf in its stored dtype, in the same structure."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        return type(tree)(*(_to_device(v, device) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return torch.from_numpy(np.array(tree)).to(device)


def _world():
    """The default process group where it holds more than one rank."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def _mesh_of(tree):
    """The device mesh of the first DTensor leaf of ``tree``, or None."""
    from ..optim.optimizer import tree_leaves
    leaves = [x for x in tree_leaves(tree) if type(x) is not torch.Tensor]
    if not leaves:
        return None
    from torch.distributed.tensor import DTensor
    return next((x.device_mesh for x in leaves if isinstance(x, DTensor)),
                None)


class Trainer:
    def __init__(self, cfg, train_step: Callable, init_state: Callable,
                 loader: PrefetchLoader, ckpt_dir: str,
                 tcfg: TrainerConfig = TrainerConfig(),
                 failer: Optional[FailureInjector] = None,
                 shardings: Any = None, device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.train_step = train_step
        self.init_state = init_state
        self.loader = loader
        self.group = _world()
        self.ckpt = Checkpointer(ckpt_dir, group=self.group)
        self.failer = failer
        self.shardings = shardings
        self.device = torch.device(device)
        self.history: list = []
        self.straggler_misses = 0

    def _fresh_or_restored(self):
        params, opt_state, extra = self.init_state()
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, (params, opt_state, extra),
                                      self.shardings)
            if self.shardings is None:
                state = _to_device(state, self.device)
            params, opt_state, extra = state
            start = latest
        return params, opt_state, extra, start

    def _next_batch(self, mesh) -> dict:
        """The loader's batch (rank 0's in a world, with its miss count)
        on ``device``, or as DTensors sharded over ``mesh``'s data axes."""
        batch = self.loader.next_batch()
        misses = self.loader.straggler_misses
        if self.group is not None:
            import torch.distributed as dist
            got = [(batch, misses)]
            dist.broadcast_object_list(got, src=0, group=self.group)
            batch, misses = got[0]
        self.straggler_misses = misses
        batch = {k: torch.from_numpy(np.asarray(v))
                 for k, v in batch.items()}
        if mesh is None:
            return {k: v.to(self.device) for k, v in batch.items()}
        from ..checkpoint.checkpointer import _place
        from ..distributed import sharding
        return sharding.zip_map(lambda v, pl: _place(v, mesh, pl), batch,
                                sharding.data_shardings(batch, mesh))

    def run(self) -> dict:
        params, opt_state, extra, start = self._fresh_or_restored()
        mesh = _mesh_of((params, opt_state, extra))
        if mesh is not None:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            from ..distributed.sharding import placements_of
            layout = placements_of((params, opt_state, extra))
        losses = []
        t0 = time.time()
        step = start
        for step in range(start, self.tcfg.total_steps):
            if self.failer is not None:
                self.failer.maybe_fail(step)
            batch = self._next_batch(mesh)
            # a plain tensor beside DTensors (the step counter, the lr)
            # is replicated
            with implicit_replication() if mesh is not None \
                    else contextlib.nullcontext():
                if self.tcfg.compress_grads:
                    params, opt_state, extra, metrics = self.train_step(
                        params, opt_state, extra, batch)
                else:
                    params, opt_state, metrics = self.train_step(
                        params, opt_state, batch)
            loss = metrics["loss"]
            if mesh is not None:
                if placements_of((params, opt_state, extra)) != layout:
                    raise RuntimeError(
                        f"step {step} changed the placements of the "
                        f"training state")
                loss = loss.full_tensor() if hasattr(loss, "full_tensor") \
                    else loss
            losses.append(float(loss))
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, (params, opt_state, extra))
            if (step + 1) % self.tcfg.log_every == 0:
                self.history.append(dict(step=step + 1, loss=losses[-1]))
        self.ckpt.save(self.tcfg.total_steps, (params, opt_state, extra),
                       blocking=True)
        return dict(final_loss=losses[-1] if losses else float("nan"),
                    losses=losses, steps=self.tcfg.total_steps - start,
                    wall_s=time.time() - t0,
                    straggler_misses=self.straggler_misses)


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      max_failures: int = 3) -> dict:
    """The outer launcher loop: restart the trainer on (injected) failures —
    the single-process analogue of a cluster controller rescheduling a job.
    In a world every rank runs it: the injected failure fires on every
    rank at the same step, and ``ckpt.wait()`` is the ranks' barrier."""
    failures = 0
    while True:
        trainer = make_trainer()
        try:
            return trainer.run() | {"restarts": failures}
        except InjectedFailure:
            failures += 1
            trainer.ckpt.wait()
            if failures > max_failures:
                raise
