#!/usr/bin/env python3
"""The readings that a cell's limits are set from, many seeds in one
process:

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        [--control-seeds 11,12,13] [--seconds 1] [--out FILE]

For each seed: the cell's set-up as a run makes it, a short window of the
cell's own loop, and the numbers of ``reference/compare.py`` for the
window's kept outputs against the float64 reference (the program's
readings), and the share of nodes whose interval is open. On each
control seed also: the control (the program's own
lower-precision path where the configuration has one, and the reference
computed in TF32 and in bfloat16) and each fault of ``faults.py`` planted
in the program's output. One JSON line a seed goes to standard output and,
with ``--out``, to FILE.
"""
import argparse
import gc
import importlib
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def read_seed(cell, seed: int, seconds: float, with_control: bool,
              device="cuda", log=None) -> dict:
    """One seed's readings: ``{source: {number: reading}}``."""
    import torch

    from portbench import faults, harness
    from portbench.reference import compare

    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    ref_mod = importlib.import_module(
        f"portbench.reference.{cell.config['program']}")
    loop = importlib.import_module(
        f"portbench.loops.{cell.traffic['loop']['kind']}")
    sync = harness._sync(device)
    t0 = time.perf_counter()
    inputs, program = harness.start(cell, seed, device, log)
    keep = random.Random(seed).randrange(harness.KEEP_RANGE)
    w = loop.run(program.forward, seconds, sync, keep)
    outs = {"program": list(w["outputs"].values())}
    if with_control:
        if program.control is not None:
            with program.control():
                outs["control_program"] = [program.forward()]
                sync()
        last = outs["program"][-1]
        for name, make in faults.FAULTS.items():
            outs[name] = [make(seed)(lambda: last)()]
    setup_s = time.perf_counter() - t0
    del program
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    rows = torch.from_numpy(inputs.rows).to(device)
    cols = torch.from_numpy(inputs.cols).to(device)
    lo, hi = ref_mod.bounds(inputs.x, rows, cols, inputs.weights)
    open_share = float((hi > lo).any(dim=1).double().mean())
    if with_control:
        for prec in ("tf32", "bfloat16"):
            outs[f"control_reference_{prec}"] = [ref_mod.forward(
                inputs.x, rows, cols, inputs.weights, precision=prec)]
    readings = {}
    for name, tensors in outs.items():
        each = [compare.gaps(t, lo, hi) for t in tensors]
        readings[name] = {k: max(r[k] for r in each) for k in each[0]}
    return {"workload": cell.name, "seed": seed, "forwards": w["count"],
            "seconds": time.perf_counter() - t0, "setup_s": setup_s,
            "open_rows": open_share, "readings": readings}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench import harness
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = harness.load_cell(args.workload, ROOT)
    harness.configure_torch()
    build.build_all(cell.config["libraries"])
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(read_seed(cell, seed, args.seconds,
                                    seed in control_seeds))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
