"""DEPRECATED — thin compatibility shim over the token serving tier
(reference: ``repro/serve/engine.py``).

The original slot-based continuous-batching loop that lived here (prefill
token-by-token into shared cache slots, one shared decode position per
tick) predates the family-adapter serving core. Token serving now lives in
:mod:`repro_torch.serve.token_session` /
:mod:`repro_torch.serve.token_engine`: the
same scheduler the GNN engines run (queues, admission, cost attribution,
span tracing) over chunked exact-``decode_step`` launches with pow2
bucketed cache shapes (no new program in steady state).

This module keeps the old names importable: :class:`Request` is unchanged,
and :class:`ServeEngine` preserves the submit/tick/run_until_done surface
by routing batches through a :class:`~repro_torch.serve.token_session.
TokenSession` — which also fixes the old loop's shared-position decode
(every slot advanced at the batch-max position, misaligning heterogeneous
prompt lengths). New code should use
:class:`~repro_torch.serve.token_engine.TokenServeEngine` directly.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional

import numpy as np

from ..configs.base import ModelConfig
from .token_session import TokenSession


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray             # (T,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[list] = None
    slot: int = -1


class ServeEngine:
    """Compatibility wrapper: the old engine surface over a TokenSession."""

    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 max_len: int = 512, eos_id: int = -1, device="cuda"):
        warnings.warn(
            "repro_torch.serve.engine.ServeEngine is deprecated; use "
            "repro_torch.serve.token_engine.TokenServeEngine (or "
            "TokenSession) instead", DeprecationWarning, stacklevel=2)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self._session = TokenSession("compat", cfg, params,
                                     max_batch=max_batch, max_len=max_len,
                                     eos_id=eos_id, device=device)

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.out_tokens = []
        self.waiting.append(req)

    def tick(self) -> int:
        """One engine iteration: serve the next FIFO batch of waiting
        requests through the token session's chunked decode."""
        if not self.waiting:
            return 0
        batch = [self.waiting.pop(0)
                 for _ in range(min(self.max_batch, len(self.waiting)))]
        outs = self._session.run(
            [np.asarray(r.prompt, np.int32) for r in batch],
            [r.max_new_tokens for r in batch])
        for r, toks in zip(batch, outs):
            r.out_tokens = [int(t) for t in toks]
            self.finished.append(r)
        return len(batch)

    def run_until_done(self, max_ticks: int = 10_000):
        ticks = 0
        while self.waiting and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.finished
