"""Model-family adapters: the seam that makes :class:`ServeCore` generic
(reference: ``repro/serve/adapters.py``).

The serving core (program counter, high-water shape buckets, async
launch/finish, trace hooks) is family-agnostic;
what a model family computes lives behind a :class:`ModelFamilyAdapter`:
``quantize``, ``upload`` (which staged arrays go to the device),
``serve_body`` (the launched forward), ``pad_operands`` (bucket shaping),
``sub_operands`` / ``operand_like`` (per-query operands and the artifact
template), ``finish``, ``trace_shape`` (and ``trace_shape_many`` of a
co-launched bucket set) and ``program_key`` (what the program counter keys
on). :class:`GNNAdapter` serves the binary GNNs; :class:`TokenAdapter`
serves the binary transformer / SSM / MoE stack token by token (the token
tier: ``token_session``, ``token_engine``).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..core import frdc
from ..kernels import fused_layer
from . import session_core


class ModelFamilyAdapter:
    """Contract one model family implements to ride the serving core.

    ``kind`` namespaces the family in metrics and trace exports.
    """

    kind = "?"

    def quantize(self, params):
        """Dense params -> the serving params the launched body uses."""
        raise NotImplementedError

    def serve_body(self, core, x, state, operands, seeds):
        """The launched body. ``x``/``seeds`` are the staged dense tensors on
        the core's device, ``operands`` the (padded) per-batch operand dict,
        ``state`` the pinned calibration. Returns the launch result."""
        raise NotImplementedError

    def pad_operands(self, core, operands, n_sub):
        """Pad one batch's operands to the core's high-water buckets;
        returns ``(n_pad, padded_operands)``. Must be monotone in the water
        marks: staging order, not launch order, is what the
        zero-steady-state-recompile guarantee keys on."""
        raise NotImplementedError

    def sub_operands(self, *args, **kw):
        """Build the operand dict for one extracted per-query closure."""
        raise NotImplementedError

    def operand_like(self):
        """Template tree for checkpoint restore validation."""
        raise NotImplementedError

    def finish(self, out_dev, staged) -> Any:
        """Wait for one launch result and crop it to host answers."""
        raise NotImplementedError

    def upload(self, core, staged):
        """The launch operands on the core's device: ``(x, operands,
        seeds)`` from the staged host arrays. Default: every array goes up
        (pinned, non-blocking)."""
        x = core._upload(staged.x_pad)
        operands = {k: {f: core._upload(v) for f, v in a.items()}
                    for k, a in staged.adjs.items()}
        return x, operands, core._upload(staged.pos_pad)

    def trace_shape(self, staged) -> dict:
        """Shape key of one staged batch, as ``on_trace`` reports it."""
        raise NotImplementedError

    def program_key(self, staged, state) -> dict:
        """What the program counter keys on: the shapes that would make
        the reference's jit trace anew. Default: :meth:`trace_shape`."""
        return self.trace_shape(staged)

    def trace_shape_many(self, stageds: List) -> dict:
        """Shape key of a co-launched bucket set."""
        shapes = [self.trace_shape(s) for s in stageds]
        out: Dict[str, Any] = dict(multi=len(stageds))
        for k in (shapes[0] if shapes else {}):
            out[k] = [s[k] for s in shapes]
        return out


class GNNAdapter(ModelFamilyAdapter):
    """The GNN serving specifics. Stateless with respect to the core (the
    water marks live on each ``ServeCore``)."""

    kind = "gnn"

    def __init__(self, plan: "session_core.SessionPlan"):
        self.plan = plan

    def quantize(self, params):
        return session_core.quantize_family(self.plan.family, params)

    def serve_body(self, core, x, state, operands, seeds):
        n_pad = x.shape[0]
        mats = {k: session_core.frdc_rebuild(v, n_pad, n_pad)
                for k, v in operands.items()}
        items = {k: fused_layer.PairItems(v["tasks"], v["n_part"])
                 for k, v in operands.items() if "tasks" in v}
        out = session_core.family_forward(self.plan, core.qparams, x, mats,
                                          use_pallas=core.use_pallas,
                                          items=items, bn_stats=state)
        return out[seeds]

    def pad_operands(self, core, operands, n_sub):
        n_pad = session_core.bucket_pow2(max(n_sub, core._n_water),
                                         core.NODE_BUCKET_FLOOR,
                                         core.node_cap)
        core._n_water = n_pad
        fused = self.plan.fused and core.use_pallas
        adjs = {}
        for k, m in operands.items():
            wkey = (n_pad, k)
            g_pad = max(core._g_water.get(wkey, 0),
                        session_core.bucket_pow2(m.n_groups,
                                                 core.GROUP_BUCKET_FLOOR))
            core._g_water[wkey] = g_pad
            padded = frdc.pad_frdc(m, n_pad, n_groups=g_pad)
            arrs = session_core.frdc_arrays(padded)
            if fused:   # the fused kernels' task list, built on the host
                arrs["tasks"], arrs["n_part"] = fused_layer.pair_items(padded)
            adjs[k] = arrs
        return n_pad, adjs

    def upload(self, core, staged):
        """As the default, but a task list's heavy count (``n_part``) stays
        a host int: the fused wrapper sizes its scratch from it."""
        x = core._upload(staged.x_pad)
        operands = {k: {f: v if f == "n_part" else core._upload(v)
                        for f, v in a.items()}
                    for k, a in staged.adjs.items()}
        return x, operands, core._upload(staged.pos_pad)

    def sub_operands(self, n_sub: int, sub_edges, dinv_sub):
        return session_core.sub_adjacency(self.plan.family, n_sub,
                                          sub_edges, dinv_sub)

    def operand_like(self):
        return session_core.adj_like(self.plan.family)

    def finish(self, out_dev, staged) -> np.ndarray:
        return out_dev.cpu().numpy()[:staged.n_seeds]

    def trace_shape(self, staged) -> dict:
        return dict(
            n_pad=int(staged.x_pad.shape[0]),
            groups={str(k): int(a["group_row"].shape[0])
                    for k, a in staged.adjs.items()})


class TokenAdapter(ModelFamilyAdapter):
    """Autoregressive token serving for the binary transformer / SSM stack.

    One launch runs ONE CHUNK of the decode: ``chunk`` exact single-token
    :func:`repro_torch.models.transformer.decode_step` calls under teacher
    forcing: global step ``p`` consumes the slot's prompt token while
    ``p < len`` and its own previous argmax after, and each step's argmax is
    the slot's generated-token stream. Running the exact step bodies (never
    the chunked prefill paths) keeps the served stream bitwise identical to
    a Python loop of ``decode_step`` at the same shapes; the session chains
    chunk launches by threading the ``(cache, prev)`` carry, so the whole
    decode stays queued on the device.

    Shape discipline: the launch operands are the (B, chunk) prompt slice
    (zero-padded), the (B,) prompt lengths, and the chunk's base position.
    The position stays a host int (``upload`` leaves it on the host): the
    cache writes and masks then never read a device scalar. The only
    growable shape is the decode-cache length, bucketed by the core's pow2
    high-water mark (``pad_operands``); the program key is the chunk shape
    and the carried state's shapes, as the reference's jit cache key is.

    ``kind`` namespaces metrics/traces: "ssm" when the config's block
    pattern contains any recurrent block (mamba / rwkv, including hybrids),
    else "transformer".
    """

    SSM_BLOCKS = ("mamba", "mamba_attn", "rwkv")

    def __init__(self, cfg):
        if getattr(cfg, "is_encdec", False):
            raise ValueError(
                "encoder-decoder configs need an encoded memory per request "
                "and are not servable through the token session")
        self.cfg = cfg
        pattern = cfg.block_pattern()
        self.kind = ("ssm" if any(k in self.SSM_BLOCKS for k in pattern)
                     else "transformer")

    def quantize(self, params):
        from ..quant.binary_linear import quantize_params
        return quantize_params(params)

    def init_state(self, batch: int, cache_len: int, device="cuda") -> dict:
        """Fresh decode carry for one batch: the KV/recurrent caches plus
        the previous-argmax feedback token (device work, built at LAUNCH,
        never in the extract stage)."""
        from ..models import transformer
        return {"cache": transformer.init_cache(self.cfg, batch, cache_len,
                                                device=device),
                "prev": torch.zeros((batch,), dtype=torch.int32,
                                    device=device)}

    def upload(self, core, staged):
        x = core._upload(np.ascontiguousarray(staged.x_pad))
        pos0 = int(staged.adjs["base"]["pos0"])
        return x, {"base": {"pos0": pos0}}, core._upload(staged.pos_pad)

    def serve_body(self, core, x, state, operands, seeds):
        from ..models import transformer
        cfg = self.cfg
        lens = seeds                           # (B,) prompt lengths
        pos0 = operands["base"]["pos0"]
        cache, prev = state["cache"], state["prev"]
        gens = []
        for i in range(x.shape[1]):
            p = pos0 + i
            tok = torch.where(p < lens, x[:, i], prev)
            logits, cache = transformer.decode_step(
                core.qparams, cfg, cache, tok[:, None], p)
            prev = torch.argmax(logits[:, 0, :cfg.vocab],
                                dim=-1).to(torch.int32)
            gens.append(prev)
        return {"gens": torch.stack(gens, dim=1),
                "state": {"cache": cache, "prev": prev}}

    def pad_operands(self, core, operands, n_sub):
        """Bucket the decode-cache length: ``n_sub`` is the batch's total
        step count, padded to the monotone pow2 water. A clamped cache
        would silently truncate the decode, so exceeding the cap raises."""
        if n_sub > core.node_cap:
            raise ValueError(
                f"decode needs {n_sub} cache positions but the session's "
                f"max_len is {core.node_cap}")
        n_pad = session_core.bucket_pow2(max(n_sub, core._n_water),
                                         core.NODE_BUCKET_FLOOR,
                                         core.node_cap)
        core._n_water = n_pad
        return n_pad, operands

    def sub_operands(self, pos0: int) -> dict:
        """Operand dict of one chunk: its base position."""
        return {"base": {"pos0": np.int32(pos0)}}

    def operand_like(self) -> dict:
        return {"base": {"pos0": np.zeros((), np.int32)}}

    def finish(self, out_dev, staged) -> np.ndarray:
        return out_dev["gens"].cpu().numpy()

    def trace_shape(self, staged) -> dict:
        return dict(batch=int(staged.x_pad.shape[0]),
                    chunk=int(staged.x_pad.shape[1]))

    def program_key(self, staged, state) -> dict:
        """The chunk shape and the shapes and dtypes of the carried state's
        leaves: a new decode-cache length is a new program, as it re-traces
        the reference's jit (an RWKV cache has no length axis, so there it
        is not)."""
        leaves = []

        def walk(node):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k])
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)
            else:
                leaves.append([list(node.shape), str(node.dtype)])
        walk(state)
        return dict(self.trace_shape(staged), state=leaves)
