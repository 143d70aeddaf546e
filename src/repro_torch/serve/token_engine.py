"""Token serving engine: the LLM decode path on the SAME scheduler the GNN
engines run (reference: ``repro/serve/token_engine.py``): queues, weighted
fair pick, admission/tenancy, cost attribution, span tracing, bounded
retry, drain/evacuate all inherited from
:class:`~repro_torch.serve.gnn_engine.GNNServeEngine` unchanged.

What changes is only the family-specific hooks: ``submit`` takes a prompt +
decode budget instead of a node id, the extract stage stages prompt chunks
(:meth:`TokenSession.prepare_batch`) instead of k-hop subgraphs, and
delivery writes each query's generated-token array (plus its
time-to-first-token, read off the prepared batch's per-chunk completion
stamps). Multi-bucket co-launch is forced off: a token batch's chunks are
a CHAIN (each launch consumes the previous chunk's device state), not
independent buckets.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .admission import DEFAULT_TENANT
from .cost import CostEstimate
from .gnn_engine import GNNServeEngine, NodeQuery
from .token_session import TokenStore


@dataclasses.dataclass
class TokenQuery(NodeQuery):
    """One generation request and, once served, its token stream.

    Shares the query protocol (qid, admission, cost, trace context, retry
    state) with :class:`NodeQuery`; ``node`` is unused (-1) and ``graph``
    empty — the queue key is (model, tenant). ``tokens`` is the generated
    int32 stream (argmax decoding, truncated at the session's eos
    inclusive); ``t_first_token`` the wall clock its first generated token
    became host-ready."""
    prompt: Optional[np.ndarray] = None
    max_new: int = 16
    tokens: Optional[np.ndarray] = None
    t_first_token: float = 0.0

    @property
    def done(self) -> bool:
        return self.tokens is not None

    @property
    def ttft_s(self) -> float:
        """Submit -> first generated token (0 until answered)."""
        if self.tokens is None or self.t_first_token <= 0.0:
            return 0.0
        return self.t_first_token - self.t_submit


class TokenServeEngine(GNNServeEngine):
    """Micro-batching scheduler over a :class:`TokenStore`'s sessions."""

    def __init__(self, store: TokenStore, **kw):
        # chunk launches are state-chained — never co-launchable buckets
        kw["multi_bucket"] = False
        kw.setdefault("mode", "subgraph")
        # metrics/trace namespace: the store's model kind (transformer/ssm)
        self.family = store.kind
        super().__init__(store, **kw)

    # ------------------------------------------------------------ intake ----
    def submit(self, model: str, prompt, max_new: int = 16,
               tenant: str = DEFAULT_TENANT) -> TokenQuery:
        """Enqueue one generation request. Validation raises (caller bug);
        admission outcomes come back typed on the query, exactly like the
        node path."""
        if model not in self.store.models:
            raise KeyError(f"unknown model {model!r}; "
                           f"have {sorted(self.store.models)}")
        prompt = np.asarray(prompt, np.int32).ravel()
        if prompt.size < 1:
            raise ValueError("empty prompt")
        max_new = int(max_new)
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        if prompt.size + max_new - 1 > self.store.max_len:
            raise ValueError(
                f"prompt[{prompt.size}] + max_new {max_new} exceeds the "
                f"store's max_len {self.store.max_len}")
        q = TokenQuery(graph="", model=model, node=-1, tenant=tenant,
                       prompt=prompt, max_new=max_new)
        if self.cost is not None:
            q.cost = self.cost.estimate_flat(prompt.size + max_new)
        return self._admit_enqueue(q, (model, tenant))

    def submit_many(self, model: str, prompts, max_new: int = 16,
                    tenant: str = DEFAULT_TENANT) -> List[TokenQuery]:
        return [self.submit(model, p, max_new=max_new, tenant=tenant)
                for p in prompts]

    # ------------------------------------------------------------- hooks ----
    def _get_session(self, key):
        return self.store.session(key[0])

    def _use_full_cache(self, session) -> bool:
        return False

    def _estimate_cost(self, *a, **kw) -> Optional[CostEstimate]:
        raise NotImplementedError(
            "token cost prediction happens in submit()")

    def _prepare_stage(self, session, batch):
        seeds = np.asarray([q.qid for q in batch], np.int64)
        prepared = session.prepare_batch([q.prompt for q in batch],
                                         [q.max_new for q in batch])
        return seeds, None, prepared

    def _deliver(self, inf, result) -> None:
        p = inf.prepared
        done_t = getattr(p, "chunk_done_t", None) or []
        for i, (q, toks) in enumerate(zip(inf.batch, result)):
            q.tokens = np.asarray(toks, np.int32)
            if done_t:
                c = min(p.first_token_chunk(i), len(done_t) - 1)
                q.t_first_token = done_t[c]

    def _trace_bucket(self, prepared) -> dict:
        if prepared is None or not prepared.groups:
            return {}
        g0 = prepared.groups[0].staged
        return dict(chunks=len(prepared.groups),
                    batch=int(g0.x_pad.shape[0]),
                    chunk=int(g0.x_pad.shape[1]),
                    cache_len=int(prepared.cache_len))

    # ------------------------------------------------------------ warmup ----
    def warmup(self, model: str, probes: int = 2, seed: int = 0) -> int:
        """Run a session's programs once and set its cache-length water,
        then arm the recompile watchdog (new programs during warmup are
        expected)."""
        self.recompile_watchdog.disarm()
        try:
            session = self._wire_session(self._get_session((model,)))
            session.sync()
            return session.warmup(np.random.default_rng(seed),
                                  probes=probes)
        finally:
            self.recompile_watchdog.arm()
