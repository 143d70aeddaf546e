#!/usr/bin/env python3
"""Where a dry-run cell's collectives come from: each functional
collective of the step's trace (``launch.dryrun._trace_cell`` on the
production mesh) summed by the line of the port that issued it and by op.

    python3 tools/dryrun_routes.py --arch qwen2-moe-a2.7b --shape train_4k \\
        [--mesh single|multi] [--layers N] [--top 20]

``--layers`` cuts the depth (the registry's otherwise; an enc-dec arch
takes it for both stacks). Runs on the CPU or the card: the tensors live
on the meta device. The line is the innermost frame in ``src/repro_torch``
outside the dry run and the sharding helpers, so an activation's
redistribution is charged to the model line that asked for it.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _site() -> str:
    for f in reversed(traceback.extract_stack()):
        if "repro_torch" in f.filename and not any(
                s in f.filename for s in ("launch/dryrun", "distributed/")):
            return f"{f.filename.split('src/')[-1]}:{f.lineno} {f.name}"
    return "(outside the port)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--top", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import SHAPES
    from repro_torch.distributed import hlo_analysis
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    by_site = collections.defaultdict(lambda: [0, 0])

    class Routed(dryrun._StepTrace):
        def add(self, func, args_, kwargs, out):
            hit = hlo_analysis.collective_payload(func, args_, out)
            if hit is not None:
                row = by_site[(_site(), hit[0])]
                row[0] += hit[1]
                row[1] += 1
            super().add(func, args_, kwargs, out)

    real = dryrun._StepTrace
    dryrun._StepTrace = Routed
    try:
        with make_production_mesh(multi_pod=args.mesh == "multi") as mesh:
            cfg = dryrun._cell_config(args.arch, "none", mesh, None)
            if args.layers:
                cut = (dict(enc_layers=args.layers, dec_layers=args.layers)
                       if cfg.is_encdec else dict(n_layers=args.layers))
                cfg = dataclasses.replace(cfg, **cut)
            shape = SHAPES[args.shape]
            m = dryrun._trace_cell(cfg, shape, mesh, dryrun._opts(cfg, shape),
                                   unroll=shape.kind == "decode")
            device = mesh.device_type
    finally:
        dryrun._StepTrace = real
    print(f"{args.arch} {args.shape} {args.mesh} (mesh of {device} type; "
          f"depth {cfg.n_layers}): wire {m['coll_wire']:.0f} bytes, "
          f"peak {m['peak']:.0f} bytes a device")
    rows = sorted(by_site.items(), key=lambda kv: -kv[1][0])
    for (site, op), (nbytes, count) in rows[:args.top]:
        print(f"  {nbytes:>16,d} B  {count:>6d} x {op:<15s} {site}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
