"""Multi-pod dry run (reference: ``repro/launch/dryrun.py``): trace every
(architecture x input-shape x mesh) cell's step for the 256- or 512-card
mesh in one process.

The reference lowers and compiles each cell's program for 512 placeholder
TPU devices and reads XLA's memory and cost analyses. The port runs its own
step instead, eagerly: ``make_train_step`` with the reference's AdamW, the
prefill ``forward``, or ``make_serve_step``. It runs on DTensors whose local
tensors live on the meta device (shapes and dtypes, no storage) over the
mesh of :func:`launch.mesh.make_production_mesh`, a fake process group for
the length of the run. Parameters take ``distributed.sharding``'s
placements (FSDP on for train), the batch ``data_shardings`` and the cache
``cache_shardings``; at the end the outputs are redistributed to the
reference's out_shardings, so that pending ``Partial`` sums are counted as
the collectives they cost. The models make plain tensors inside (RoPE
tables, masks, ``arange``): ``implicit_replication`` treats them as
replicated. A dispatch mode (:class:`_StepTrace`) watches the local ops that
rank 0 runs:

- ``per_device_hbm_bytes``: the peak of live local bytes over the step.
  The caller's arguments count from the start; each storage an op creates
  is added, and taken off when it is freed. The port's AdamW is
  functional, so the old and new parameter and moment trees live together
  as the step really holds them. The reference divides XLA's already
  per-device figure by the device count again; this is the figure per
  device.
- ``flops_per_device``: ``torch.utils.flop_counter``'s formulas (those of
  ``FlopCounterMode``: matmul-like ops only) on each local op.
- ``bytes_per_device``: each local op's input and output bytes, views and
  bare allocations left out. XLA counts the bytes of fused kernels; eager
  ops count every intermediate.
- ``collective_bytes_per_device``: the functional collectives DTensor
  issues, by ``distributed.hlo_analysis``'s conventions.

Probes (the reference's ``_probe_plan`` and ``_affine_probe``): steps of 1
and 2 layers (or pattern periods; the SSM and hybrid archs at 2 x 2
(layers, tokens), the tokens a whole number of chunks a model shard)
extrapolated to the full depth for flops, bytes and
collective bytes, as the reference takes them (XLA counts a scanned layer
once). The memory comes from the full-depth trace, as the reference's from
its full program: the peak moves between phases of the step as the depth
grows, so it does not extrapolate. A full trace takes seconds a layer, and
minutes a layer for the SSM chunk loops of a train cell.

Run one cell:   python -m repro_torch.launch.dryrun --arch smollm-135m \\
                    --shape train_4k --mesh single
Run everything: python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch

from ..distributed import hlo_analysis, sharding

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# allocations, and ops that only hand back what they were given
_NO_TRAFFIC = ("empty", "new_empty", "_wrap_tensor_autograd", "wait_tensor")


def _opts(cfg, shape):
    return dict(
        remat=shape.kind == "train",
        seq_shard=shape.kind in ("train", "prefill"),
        q_chunk=2048 if shape.seq_len >= 8192 else 0,
        donate_cache=shape.kind == "decode",
    )


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


class _StepTrace(hlo_analysis.CollectiveRecorder):
    """Rank 0's local ops of one step: flops, bytes, collectives, and the
    live bytes of the storages they hold."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._sizes = {}        # id(storage) -> bytes, while it lives

    def _track(self, t: torch.Tensor) -> None:
        if type(t) is not torch.Tensor:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = self._sizes[key] = st.nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key)

    def storages(self, tree) -> dict:
        """id -> bytes of the local storages of ``tree``'s tensors, each
        registered as live (the step's arguments, held by its caller)."""
        out = {}
        for t in _tensors(tree):
            loc = _local(t)
            self._track(loc)
            out[id(loc.untyped_storage())] = loc.untyped_storage().nbytes()
        return out

    def add(self, func, args, kwargs, out) -> None:
        outs, ins = _tensors(out), _tensors((args, kwargs))
        if not any(t.device.type == "meta" for t in outs + ins):
            return      # DTensor's own bookkeeping (shard offsets), on CPU
        super().add(func, args, kwargs, out)
        from torch.utils.flop_counter import flop_registry
        for t in outs:
            self._track(t)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        if func.is_view or func._opname.startswith(_NO_TRAFFIC):
            return
        seen = {id(t.untyped_storage()) for t in ins
                if type(t) is torch.Tensor}
        self.bytes += sum(t.numel() * t.element_size() for t in ins)
        self.bytes += sum(t.numel() * t.element_size() for t in outs
                          if type(t) is not torch.Tensor
                          or id(t.untyped_storage()) not in seen)


def _place(tree, placements, mesh):
    """The meta tensors of ``tree`` as DTensors with ``placements``: each
    a local meta tensor of this rank's shard shape."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    def one(t, pl):
        shape, _ = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        local = torch.empty(shape, dtype=t.dtype, device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return sharding.zip_map(one, tree, placements)


def _axis(mesh, name: str) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index(name)) if name in names else 1


def _trace_cell(cfg, shape, mesh, opts, unroll: bool, opt=None) -> dict:
    """Run the cell's step once on meta DTensors over ``mesh`` under
    :class:`_StepTrace`; returns its counts. ``opt``: the train step's
    optimizer (the reference's AdamW by default). The counts come back
    flat: flops, bytes, coll_wire, the memory fields and peak, and
    ``("coll", op, "bytes" | "count")`` for each collective."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models import transformer
    from ..optim.optimizer import AdamW, AdamWState
    from ..quant.binary_linear import quantize_params
    from ..train import train_step as ts

    dp = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
    boundary = sharding.placements((dp, "model", None), mesh) \
        if opts["seq_shard"] else None
    logits_sh = sharding.logits_sharding(mesh, shape.global_batch)

    params = transformer.init_params(cfg, torch.Generator(), "meta")
    if cfg.quant == "bitgnn":
        params = quantize_params(params)
    p_pl = sharding.param_placements(params, mesh,
                                     fsdp=(shape.kind == "train"))
    params = _place(params, p_pl, mesh)
    batch = ts.input_specs(cfg, shape)
    trace = _StepTrace()
    with implicit_replication():
        if shape.kind == "decode":   # the whole program; the last position
            c_pl = sharding.cache_shardings(batch["cache"], mesh)
            cache = _place(batch["cache"], c_pl, mesh)
            tokens = _place(batch["tokens"],
                            sharding.data_shardings(batch["tokens"], mesh),
                            mesh)
            step = ts.make_serve_step(cfg)
            args = trace.storages((params, cache, tokens))
            with trace:
                logits, new_cache = step(params, cache, tokens,
                                         shape.seq_len - 1)
                out = (sharding.redistribute_tree(logits, logits_sh),
                       sharding.redistribute_tree(new_cache, c_pl))
        else:
            batch = _place(batch, sharding.data_shardings(batch, mesh), mesh)
        if shape.kind == "prefill":
            step = ts.make_prefill_step(cfg, q_chunk=opts["q_chunk"],
                                        boundary_sharding=boundary,
                                        logits_sharding=logits_sh)
            args = trace.storages((params, batch))
            with trace:
                out = sharding.redistribute_tree(step(params, batch),
                                                 logits_sh)
        if shape.kind == "train":
            opt = opt or AdamW(lr=1e-4, weight_decay=0.1, clip_norm=1.0)
            opt_state = opt.init(params)
            step = ts.make_train_step(cfg, opt, unroll=unroll,
                                      q_chunk=opts["q_chunk"],
                                      remat=opts["remat"],
                                      boundary_sharding=boundary,
                                      logits_sharding=logits_sh)
            args = trace.storages((params, opt_state, batch))
            with trace:
                p2, o2, metrics = step(params, opt_state, batch)
                rep = sharding.replicated(mesh)
                move = sharding.redistribute_tree
                out = (move(p2, p_pl), move(o2, AdamWState(rep, p_pl, p_pl)),
                       move(metrics, {k: rep for k in metrics}))
    outs = {id(_local(t).untyped_storage()):
            _local(t).untyped_storage().nbytes() for t in _tensors(out)}
    colls = trace.stats()
    argument = sum(args.values())
    m = dict(flops=float(trace.flops), bytes=float(trace.bytes),
             coll_wire=float(colls.wire_bytes), argument=float(argument),
             output=float(sum(outs.values())),
             temp=float(trace.peak - argument),
             alias=float(sum(n for k, n in outs.items() if k in args)),
             peak=float(trace.peak))
    for op, b in colls.bytes_by_op.items():
        m[("coll", op, "bytes")] = float(b)
        m[("coll", op, "count")] = float(colls.count_by_op[op])
    return m


def _affine_probe(cfg, shape, mesh, opts, measure_key_fn):
    """SSM/hybrid probes: chunked-linear archs have step cost AFFINE in
    (L, T) — f(L,T) = ba + bb*T + L*la + L*lb*T. Four small probes at
    (L1,T1),(L1,T2),(L2,T1),(L2,T2) solve the system exactly; evaluate at
    (L*, T*), for every count of :func:`_trace_cell`. Zamba2's
    shared-attention is quadratic in T — corrected analytically (DESIGN.md
    §7)."""
    import dataclasses as dc

    from ..models import ssm
    hybrid = cfg.family == "hybrid" and cfg.attn_every
    p = cfg.attn_every if hybrid else 1
    l1, l2 = p, 2 * p
    # the reference probes at 512 and 1024 tokens; DTensor splits a
    # sequence sharded over the model axis into whole chunks only, so the
    # probes take the least such length and twice it
    chunk = ssm.CHUNK if hybrid else min(ssm.CHUNK, 64)
    t1 = chunk * _axis(mesh, "model")
    t2 = 2 * t1
    ls, ts = cfg.n_layers / p * p, shape.seq_len   # L* counted in layers
    lstar = cfg.n_layers / p                        # in periods
    fs = {}
    for li in (l1, l2):
        for ti in (t1, t2):
            pcfg = dc.replace(cfg, n_layers=li)
            pshape = dc.replace(shape, seq_len=ti)
            fs[(li, ti)] = _trace_cell(pcfg, pshape, mesh,
                                       {**opts, "q_chunk": 0}, unroll=True)

    def solve(key):
        f11, f12 = fs[(l1, t1)].get(key, 0.0), fs[(l1, t2)].get(key, 0.0)
        f21, f22 = fs[(l2, t1)].get(key, 0.0), fs[(l2, t2)].get(key, 0.0)
        lb = (f22 - f21 - f12 + f11) / ((l2 - l1) / p * (t2 - t1))
        la = (f21 - f11) / ((l2 - l1) / p) - lb * t1
        bb = (f12 - f11) / (t2 - t1) - (l1 / p) * lb
        ba = f11 - bb * t1 - (l1 / p) * (la + lb * t1)
        return ba + bb * ts + lstar * (la + lb * ts)

    out = {k: solve(k) for k in set().union(*fs.values())}
    if hybrid and cfg.n_heads:
        # quadratic shared-attention correction (scores + AV): the affine
        # fit linearizes through (t1, t2); add the residual at T*.
        dp = _axis(mesh, "data") * _axis(mesh, "pod")
        b_loc = max(shape.global_batch // dp, 1)
        h_loc = (cfg.n_heads_padded or cfg.n_heads) // cfg.tp
        passes = 4.0 if shape.kind == "train" else 1.0
        n_attn = cfg.n_layers / cfg.attn_every

        def quad(t):
            return 2 * 2 * b_loc * h_loc * float(t) ** 2 * cfg.head_dim
        line = quad(t1) + (quad(t2) - quad(t1)) / (t2 - t1) * (ts - t1)
        out["flops"] += passes * n_attn * (quad(ts) - line)
    return out


def _probe_plan(cfg):
    """(probe configs, combine fn) for per-layer extrapolation."""
    if cfg.is_encdec:
        p1 = dataclasses.replace(cfg, enc_layers=1, dec_layers=1)
        p2 = dataclasses.replace(cfg, enc_layers=2, dec_layers=2)
        n = cfg.dec_layers

        def combine(f1, f2):
            return f1 + (n - 1) * (f2 - f1)
        return [p1, p2], combine
    if cfg.family == "hybrid" and cfg.attn_every:
        p = cfg.attn_every
        n_periods, leftover = divmod(cfg.n_layers, p)
        p1 = dataclasses.replace(cfg, n_layers=p)
        p2 = dataclasses.replace(cfg, n_layers=2 * p)
        p3 = dataclasses.replace(cfg, n_layers=p + 1)

        def combine(f1, f2, f3):
            return (f1 + (n_periods - 1) * (f2 - f1) + leftover * (f3 - f1))
        return [p1, p2, p3], combine
    p1 = dataclasses.replace(cfg, n_layers=1)
    p2 = dataclasses.replace(cfg, n_layers=2)
    n = cfg.n_layers

    def combine(f1, f2):
        return f1 + (n - 1) * (f2 - f1)
    return [p1, p2], combine


def _cell_config(arch, quant, mesh, cfg_overrides):
    from ..configs import get_config
    cfg = get_config(arch).resolve_for_mesh(tp=_axis(mesh, "model"))
    if quant != "none":
        cfg = dataclasses.replace(cfg, quant=quant)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    return cfg


def _probe(cfg, shape, mesh, opts) -> dict:
    """The counts of :func:`_trace_cell` at the full depth, extrapolated
    from the probes of :func:`_probe_plan` (:func:`_affine_probe` for the
    SSM and hybrid archs)."""
    if cfg.family in ("ssm", "hybrid"):
        return _affine_probe(cfg, shape, mesh, opts, None)
    probe_cfgs, combine = _probe_plan(cfg)
    ms = [_trace_cell(pcfg, shape, mesh, opts, unroll=True)
          for pcfg in probe_cfgs]
    return {k: combine(*[m.get(k, 0.0) for m in ms])
            for k in set().union(*ms)}


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             quant: str = "none", probe: bool = True,
             opt_overrides: dict | None = None,
             cfg_overrides: dict | None = None) -> dict:
    """One cell's counts, in the reference's result dict: the memory and
    the collectives by op from one trace at the full depth; with ``probe``
    (train and prefill cells) flops, bytes and collective bytes from the
    probes, as the reference takes them."""
    from ..configs import SHAPES, get_config
    from .mesh import make_production_mesh

    t_start = time.time()
    with make_production_mesh(multi_pod=(mesh_kind == "multi")) as mesh:
        shape = SHAPES[shape_name]
        cfg = _cell_config(arch, quant, mesh, cfg_overrides)
        opts = _opts(cfg, shape)
        if opt_overrides:
            opts.update(opt_overrides)

        unroll_main = shape.kind == "decode"
        main = _trace_cell(cfg, shape, mesh, opts, unroll=unroll_main)
        t_lower = time.time()
        probes = {}
        if probe and not unroll_main:
            probes = _probe(cfg, shape, mesh, opts)
        n_dev = mesh.size()
    t_probe = time.time()

    colls = sorted({k[1] for k in main if isinstance(k, tuple)})
    base = get_config(arch)
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "quant": quant, "n_devices": int(n_dev),
        "opts": {k: (bool(v) if isinstance(v, bool) else v)
                 for k, v in opts.items()},
        "mode": "unrolled+probe" if probes else "unrolled-exact",
        "lower_s": round(t_lower - t_start, 2),
        "compile_s": 0.0,
        "probe_s": round(t_probe - t_lower, 2),
        "flops_per_device": float(probes.get("flops", main["flops"])),
        "bytes_per_device": float(probes.get("bytes", main["bytes"])),
        "collective_bytes_per_device": float(
            probes.get("coll_wire", main["coll_wire"])),
        "collectives_scanned_program": {
            op: [int(main[("coll", op, "bytes")]),
                 int(main[("coll", op, "count")])] for op in colls},
        "memory": {**{k: int(main[k]) for k in
                      ("argument", "output", "temp", "alias")},
                   "per_device_hbm_bytes": int(main["peak"])},
        "model": {
            "params": int(base.param_count()),
            "params_padded": int(cfg.param_count(padded=True)),
            "active_params": int(base.active_param_count()),
        },
    }


def cell_name(arch, shape, mesh_kind, quant="none"):
    q = "" if quant == "none" else f"-{quant}"
    return f"{arch}__{shape}__{mesh_kind}{q}"


def all_cells():
    """Single-pod cells first, then multi-pod."""
    from ..configs import ARCHS, shapes_for
    for mesh_kind in ("single", "multi"):
        for arch in sorted(ARCHS):
            for shape in shapes_for(arch):
                yield arch, shape, mesh_kind


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--quant", default="none", choices=["none", "bitgnn"])
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    RESULTS.mkdir(parents=True, exist_ok=True)

    if args.all:
        failures = []
        for arch, shape, mesh_kind in all_cells():
            out = RESULTS / f"{cell_name(arch, shape, mesh_kind)}.json"
            if out.exists() and not args.force:
                print(f"[skip] {out.name}", flush=True)
                continue
            print(f"[run ] {arch} x {shape} x {mesh_kind}", flush=True)
            t0 = time.time()
            try:
                result = run_cell(arch, shape, mesh_kind,
                                  probe=(mesh_kind == "single"))
                out.write_text(json.dumps(result, indent=2))
                print(f"[done] {out.name} ({time.time()-t0:.0f}s)",
                      flush=True)
            except Exception:
                failures.append((arch, shape, mesh_kind))
                traceback.print_exc()
        print(f"\n{len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    try:
        result = run_cell(args.arch, args.shape, args.mesh, quant=args.quant,
                          probe=not args.no_probe)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    out = RESULTS / f"{cell_name(args.arch, args.shape, args.mesh, args.quant)}.json"
    out.write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
