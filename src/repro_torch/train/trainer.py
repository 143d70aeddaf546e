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
tensor). Restoring under ``shardings`` (an elastic re-mesh) needs a device
mesh and raises.
"""
from __future__ import annotations

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


class Trainer:
    def __init__(self, cfg, train_step: Callable, init_state: Callable,
                 loader: PrefetchLoader, ckpt_dir: str,
                 tcfg: TrainerConfig = TrainerConfig(),
                 failer: Optional[FailureInjector] = None,
                 shardings: Any = None, device="cuda"):
        if shardings is not None:
            raise NotImplementedError(
                "training under shardings (an elastic re-mesh) needs a train "
                "step over DTensor parameters; it comes with slice G-b "
                "(ROADMAP Queue 1 item 3). Checkpointer.restore(shardings=) "
                "re-places a checkpoint already")
        self.cfg = cfg
        self.tcfg = tcfg
        self.train_step = train_step
        self.init_state = init_state
        self.loader = loader
        self.ckpt = Checkpointer(ckpt_dir)
        self.failer = failer
        self.device = torch.device(device)
        self.history: list = []

    def _fresh_or_restored(self):
        params, opt_state, extra = self.init_state()
        start = 0
        latest = self.ckpt.latest_step()
        if latest is not None:
            state = self.ckpt.restore(latest, (params, opt_state, extra))
            params, opt_state, extra = _to_device(state, self.device)
            start = latest
        return params, opt_state, extra, start

    def run(self) -> dict:
        params, opt_state, extra, start = self._fresh_or_restored()
        losses = []
        t0 = time.time()
        step = start
        for step in range(start, self.tcfg.total_steps):
            if self.failer is not None:
                self.failer.maybe_fail(step)
            batch = self.loader.next_batch()
            batch = {k: torch.from_numpy(np.asarray(v)).to(self.device)
                     for k, v in batch.items()}
            if self.tcfg.compress_grads:
                params, opt_state, extra, metrics = self.train_step(
                    params, opt_state, extra, batch)
            else:
                params, opt_state, metrics = self.train_step(
                    params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            if (step + 1) % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step + 1, (params, opt_state, extra))
            if (step + 1) % self.tcfg.log_every == 0:
                self.history.append(dict(step=step + 1, loss=losses[-1]))
        self.ckpt.save(self.tcfg.total_steps, (params, opt_state, extra),
                       blocking=True)
        return dict(final_loss=losses[-1] if losses else float("nan"),
                    losses=losses, steps=self.tcfg.total_steps - start,
                    wall_s=time.time() - t0,
                    straggler_misses=self.loader.straggler_misses)


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      max_failures: int = 3) -> dict:
    """The outer launcher loop: restart the trainer on (injected) failures —
    the single-process analogue of a cluster controller rescheduling a job."""
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
