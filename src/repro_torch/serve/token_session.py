"""Token serving sessions: the binary transformer / SSM decode path riding
the SAME :class:`~repro_torch.serve.session_core.ServeCore` the GNN
sessions use (reference: ``repro/serve/token_session.py``).

A :class:`TokenSession` owns one serve core whose adapter is a
:class:`~repro_torch.serve.adapters.TokenAdapter`: a launch runs one CHUNK
of exact single-token ``decode_step`` calls (teacher-forced; see the
adapter), and a batch of requests becomes a :class:`TokenPreparedBatch`
whose groups are the decode's chunks in step order. ``launch_batch``
threads the ``(cache, prev)`` carry through the chunk launches; each
chunk's kernels are queued on the device stream behind the previous
chunk's, so the whole decode is in flight after the last launch returns
(the host issues every kernel of it first). ``finish_batch`` blocks chunk
by chunk (stamping per-chunk completion times, the engine's time-to-first-
token source) and slices each request's generated tokens out of the global
argmax stream.

Step math: global step ``t`` consumes slot ``s``'s prompt token while
``t < len_s`` and its previous argmax after; generated token ``j`` of slot
``s`` is the argmax output of step ``len_s - 1 + j``. The batch runs
``ceil(S / chunk)`` chunks where ``S = max_s(len_s + max_new_s - 1)``; the
decode-cache length is the pow2 high-water bucket of the total step count,
so steady-state serving adds no program across prompt/decode lengths.

The staged chunk arrays are pure host work (the extract-stage purity the
transfer watchdog checks); the decode caches are allocated at LAUNCH. A
prepared batch pins its serve core at extract time — ``update_params``
swaps the session's core, and in-flight batches finish under the params
they were staged for (the token twin of the GNN sessions' pinned BN).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import adapters
from .session_core import (PreparedBatch, PreparedGroup, ServeCore,
                           SessionPlan, StagedBatch)


def _to_device(tree, device):
    """The params tree with every tensor on ``device`` (no copy for a
    tensor already there)."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@dataclasses.dataclass
class TokenPreparedBatch(PreparedBatch):
    """Extract-stage output of one token micro-batch: the decode's chunks
    as :class:`PreparedGroup`\\ s (all on the session's core, in step
    order) plus the per-request slicing data. ``bn`` stays None — the
    decode carry is built fresh at launch, and the params are pinned via
    the groups' core."""
    lens: Optional[np.ndarray] = None       # (n,) prompt lengths
    max_news: Optional[np.ndarray] = None   # (n,) decode budgets
    cache_len: int = 0                      # bucketed decode-cache length
    chunk: int = 0
    eos_id: int = -1
    # finish() fills this: wall time each chunk's result became host-ready,
    # the engine's per-query time-to-first-token source
    chunk_done_t: List[float] = dataclasses.field(default_factory=list)

    def launch(self) -> list:
        """Dispatch the decode: fresh carry, then every chunk chained on
        the previous chunk's device state. Async: each launch returns with
        the device work in flight; only finish() blocks."""
        core = self.groups[0].core
        state = core.adapter.init_state(core.max_batch, self.cache_len,
                                        device=core.device)
        devs = []
        for g in self.groups:
            out = core.launch(g.staged, state)
            state = out["state"]
            devs.append(out["gens"])
        return devs

    def finish(self, devs: list) -> List[np.ndarray]:
        """Block on the chunks in step order and slice each request's
        generated tokens (truncated at ``eos_id`` inclusive, when set) out
        of the global argmax stream. Returns per-request int32 arrays in
        request order."""
        self.chunk_done_t = []
        cols = []
        for d in devs:
            cols.append(d.cpu().numpy())
            self.chunk_done_t.append(time.perf_counter())
        gens = np.concatenate(cols, axis=1)
        outs: List[np.ndarray] = []
        for i in range(self.n_uniq):
            ln, mn = int(self.lens[i]), int(self.max_news[i])
            row = gens[i, ln - 1: ln - 1 + mn]
            if self.eos_id >= 0:
                hit = np.nonzero(row == self.eos_id)[0]
                if hit.size:
                    row = row[: int(hit[0]) + 1]
            outs.append(np.array(row, np.int32))
        return outs

    def first_token_chunk(self, i: int) -> int:
        """Chunk index whose completion carries request ``i``'s first
        generated token (step ``len_i - 1``)."""
        return (int(self.lens[i]) - 1) // self.chunk


class TokenSession:
    """One token-serving session: config + (optionally bit-packed)
    params behind one :class:`ServeCore` running the chunked decode.

    Mirrors the surface the serving engines drive on the GNN sessions:
    ``prepare_batch`` / ``launch_batch`` / ``finish_batch``, ``warmup``,
    ``sync``, ``set_trace_hook``, ``compile_count`` / ``dispatch_count`` /
    ``invalidations``. ``run`` composes the three stages serially, so
    serial and pipelined serving are bit-exact by construction."""

    def __init__(self, name: str, cfg, params, max_batch: int = 4,
                 max_len: int = 1024, chunk: int = 8,
                 quantize: bool = False, eos_id: int = -1,
                 warm_len: int = 16, warm_new: int = 8, device="cuda"):
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        self.name = name
        self.cfg = cfg
        self.params = params
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.chunk = int(chunk)
        self.quantized = bool(quantize)
        self.eos_id = int(eos_id)
        self.warm_len = int(warm_len)
        self.warm_new = int(warm_new)
        self.device = torch.device(device)
        self.adapter = adapters.TokenAdapter(cfg)
        self.plan = SessionPlan(family=self.adapter.kind, scheme="token")
        self.invalidations = 0
        self._trace_cb = None
        # cumulative counters across param swaps (a swap rebuilds the core)
        self._compiles_base = 0
        self._dispatch_base = 0
        self.core = self._build_core(params)

    def _build_core(self, params) -> ServeCore:
        params = _to_device(params, self.device)
        qp = self.adapter.quantize(params) if self.quantized else params
        core = ServeCore(self.plan, qp, self.max_batch,
                         node_cap=self.max_len, adapter=self.adapter,
                         device=self.device)
        if self._trace_cb is not None:
            cb = self._trace_cb
            core.on_trace = lambda shape: cb("token", shape)
        return core

    # ------------------------------------------------------------ counters --
    @property
    def compile_count(self) -> int:
        return self._compiles_base + self.core.compile_count

    @property
    def dispatch_count(self) -> int:
        return self._dispatch_base + self.core.n_dispatches

    def set_trace_hook(self, cb) -> None:
        self._trace_cb = cb
        self.core.on_trace = lambda shape: cb("token", shape)

    def sync(self) -> None:
        """No cached full pass on the token path — nothing to build."""

    # -------------------------------------------------------------- stages --
    def prepare_batch(self, prompts: Sequence[np.ndarray],
                      max_news: Sequence[int]) -> TokenPreparedBatch:
        """EXTRACT: stage one batch's chunk grid. Pure host work — the
        water-mark update happens here, so staging order is what the
        zero-recompile guarantee keys on (exactly like the GNN stage)."""
        n = len(prompts)
        if not 0 < n <= self.max_batch:
            raise ValueError(f"batch of {n} prompts for a session with "
                             f"max_batch={self.max_batch}")
        lens = np.asarray([int(np.asarray(p).size) for p in prompts],
                          np.int64)
        mns = np.asarray([int(m) for m in max_news], np.int64)
        if lens.min() < 1:
            raise ValueError("empty prompt")
        if mns.min() < 1:
            raise ValueError("max_new must be >= 1")
        s_needed = int((lens + mns).max()) - 1
        n_chunks = -(-s_needed // self.chunk)
        steps = n_chunks * self.chunk
        cache_len, _ = self.adapter.pad_operands(self.core, {}, steps)
        grid = np.zeros((self.max_batch, steps), np.int32)
        lens_pad = np.zeros((self.max_batch,), np.int32)
        for i, p in enumerate(prompts):
            p = np.asarray(p, np.int32).ravel()
            grid[i, :p.size] = p
            lens_pad[i] = p.size
        groups = []
        for c in range(n_chunks):
            staged = StagedBatch(
                x_pad=grid[:, c * self.chunk:(c + 1) * self.chunk],
                adjs=self.adapter.sub_operands(c * self.chunk),
                pos_pad=lens_pad, n_seeds=n)
            groups.append(PreparedGroup(core=self.core,
                                        sel=np.arange(n), staged=staged))
        return TokenPreparedBatch(
            n_uniq=n, inverse=np.arange(n), groups=groups, bn=None,
            lens=lens, max_news=mns, cache_len=cache_len,
            chunk=self.chunk, eos_id=self.eos_id)

    def launch_batch(self, prepared: TokenPreparedBatch) -> list:
        return prepared.launch()

    def finish_batch(self, prepared: TokenPreparedBatch,
                     devs: list) -> List[np.ndarray]:
        return prepared.finish(devs)

    def run(self, prompts: Sequence[np.ndarray],
            max_news: Sequence[int]) -> List[np.ndarray]:
        """Serial stage -> launch -> finish of one batch of prompts."""
        prepared = self.prepare_batch(prompts, max_news)
        return self.finish_batch(prepared, self.launch_batch(prepared))

    # -------------------------------------------------------------- warmup --
    def warmup(self, rng: np.random.Generator, probes: int = 2) -> int:
        """Run the programs once and set the cache-length water at the
        session's warm sizes (``warm_len`` + ``warm_new``); any workload
        whose step count stays under the resulting pow2 bucket then serves
        with zero steady-state recompiles. Returns compiles triggered."""
        c0 = self.compile_count
        for _ in range(max(1, min(int(probes), 2))):
            prompts = [rng.integers(0, self.cfg.vocab,
                                    self.warm_len).astype(np.int32)
                       for _ in range(self.max_batch)]
            self.run(prompts, [self.warm_new] * self.max_batch)
        return self.compile_count - c0

    # --------------------------------------------------------- param swaps --
    def update_params(self, params, quantize: Optional[bool] = None) -> None:
        """Hot-swap the served params: a NEW core (the program closes over
        the packed weights) while in-flight prepared batches keep the old
        core pinned via their groups. The bucket water carries over, so the
        swap costs one new program at the established shapes, not a
        warmup."""
        if quantize is not None:
            self.quantized = bool(quantize)
        self.params = params
        old = self.core
        self._compiles_base += old.compile_count
        self._dispatch_base += old.n_dispatches
        self.core = self._build_core(params)
        self.core._n_water = old._n_water
        self.invalidations += 1


@dataclasses.dataclass
class TokenModelEntry:
    """Registry entry of one servable token model."""
    name: str
    cfg: object
    params: object
    quantize: bool = False
    kind: str = "transformer"


class TokenStore:
    """Registry of token models + their lazily-built sessions — the token
    twin of :class:`~repro_torch.serve.gnn_session.GraphStore`, exposing the
    surface the engines read (``models``, ``_sessions``, ``max_batch``,
    ``session()``)."""

    def __init__(self, max_batch: int = 4, max_len: int = 1024,
                 chunk: int = 8, eos_id: int = -1,
                 warm_len: int = 16, warm_new: int = 8, device="cuda"):
        self.device = torch.device(device)
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.chunk = int(chunk)
        self.eos_id = int(eos_id)
        self.warm_len = int(warm_len)
        self.warm_new = int(warm_new)
        self.models: Dict[str, TokenModelEntry] = {}
        self._sessions: Dict[str, TokenSession] = {}

    @property
    def kind(self) -> str:
        """Model-family namespace of the store's engines: the registered
        models' shared kind, or "token" for an empty/mixed store."""
        kinds = {e.kind for e in self.models.values()}
        return kinds.pop() if len(kinds) == 1 else "token"

    def register_model(self, name: str, cfg, params,
                       quantize: bool = False) -> TokenModelEntry:
        entry = TokenModelEntry(name=name, cfg=cfg, params=params,
                                quantize=bool(quantize),
                                kind=adapters.TokenAdapter(cfg).kind)
        self.models[name] = entry
        return entry

    def session(self, name: str) -> TokenSession:
        s = self._sessions.get(name)
        if s is None:
            e = self.models[name]
            s = self._sessions[name] = TokenSession(
                name, e.cfg, e.params, max_batch=self.max_batch,
                max_len=self.max_len, chunk=self.chunk,
                quantize=e.quantize, eos_id=self.eos_id,
                warm_len=self.warm_len, warm_new=self.warm_new,
                device=self.device)
        return s

    def update_params(self, name: str, params) -> None:
        e = self.models[name]
        e.params = params
        s = self._sessions.get(name)
        if s is not None:
            s.update_params(params)
