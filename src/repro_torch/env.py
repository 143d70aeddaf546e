"""Opt-in CUDA process-environment tuning for collective overlap (reference:
``repro/env.py``, whose ``xla_tuned`` sets XLA's latency-hiding and
async-collective flags).

``ProcessGroupNCCL`` reads these variables once, when CUDA and the
process group come up, so they must be in the environment BEFORE anything
initializes CUDA: this module imports no torch (it looks torch up in
``sys.modules``). The set is what the overlap of collectives with compute
relies on, kept to the names the installed torch reads (both are in
``libtorch_cuda.so`` of torch 2.11):

- ``TORCH_NCCL_HIGH_PRIORITY=1``: ``ProcessGroupNCCL`` runs its
  communication streams at high priority, so a collective is scheduled
  ahead of the compute kernels it overlaps.
- ``TORCH_NCCL_AVOID_RECORD_STREAMS=1``: ``ProcessGroupNCCL`` keeps a
  collective's tensors alive itself instead of ``record_stream`` on the
  caching allocator, which delays their reuse.

``CUDA_DEVICE_MAX_CONNECTIONS=1`` (one hardware queue a device, so kernels
start in launch order) is left out: the CUDA driver reads it, no torch
source or library names it, and torch's own tensor-parallel code does not
ask for it.

Deliberately OPT-IN and never overriding: a variable the user set wins
unconditionally (their tuning, not ours), and once CUDA is initialized the
writes would be silent no-ops, so we refuse and warn instead of pretending
they took effect. Nothing on the port's main path calls it: the port runs
no collective on one card, and no gain is claimed.
"""
from __future__ import annotations

import os
import sys
import warnings

CUDA_TUNED_ENV = {
    "TORCH_NCCL_HIGH_PRIORITY": "1",
    "TORCH_NCCL_AVOID_RECORD_STREAMS": "1",
}


def _cuda_initialized() -> bool:
    """Whether this process has initialized CUDA (torch imported and its
    CUDA state up); torch is not imported here."""
    torch = sys.modules.get("torch")
    cuda = getattr(torch, "cuda", None)
    return bool(cuda is not None and cuda.is_initialized())


def cuda_tuned(env: dict = os.environ) -> bool:
    """Install :data:`CUDA_TUNED_ENV` into ``env``; True when applied.

    A variable already in ``env`` keeps its value (the user's wins).
    No-op returning False when the user set all of them, or when CUDA is
    already initialized (the variables could no longer take effect —
    warns, so a mis-ordered call site is loud rather than silently
    untuned)."""
    missing = {k: v for k, v in CUDA_TUNED_ENV.items() if k not in env}
    if not missing:
        return False
    if _cuda_initialized():
        warnings.warn(
            "repro_torch.env.cuda_tuned() called after CUDA init; the "
            "variables would be ignored — call it before anything "
            "initializes CUDA", RuntimeWarning, stacklevel=2)
        return False
    env.update(missing)
    return True
