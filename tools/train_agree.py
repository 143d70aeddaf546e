#!/usr/bin/env python3
"""Phase 13 of ``chip_smoke.py`` (``run_train``) run several times in one
process: four models trained anew on full Flickr on the card each time,
their weights packed and held against the CPU by ``chip_smoke.agree``
(rows close and predictions at 99.9%), then served fused and timed as the
script does. Training on the card is not deterministic, so each run packs
other weights; the CPU forwards sum the fp aggregation in the card's order
(``chip_smoke.walk_fp``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/train_agree.py [--runs 3]

Prints each check's rows close, predictions and max |dlogit| by run, and
a JSON summary; exits 1 if a run failed a check.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.graphs.datasets import make_dataset  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


def main() -> int:
    runs = int(sys.argv[sys.argv.index("--runs") + 1]) \
        if "--runs" in sys.argv else 3
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    flickr = make_dataset("flickr", seed=chip_smoke.SEED, scale=1.0)
    adjs = {k: flickr.adjacency(k, "cuda") for k in ("gcn", "binary", "mean")}
    real = chip_smoke.agree
    summary = []

    def agree(what, got, want):
        try:
            figures = real(what, got, want)
        except AssertionError:
            summary[-1]["checks"][what] = "failed"
            raise
        summary[-1]["checks"][what] = dict(zip(
            ("rows_close", "predictions", "max_abs_dlogit"), figures))
        return figures
    chip_smoke.agree = agree
    for r in range(runs):
        summary.append({"run": r, "checks": {}})
        t0 = time.perf_counter()
        try:
            chip_smoke.run_train(torch, flickr, adjs)
            summary[-1]["passed"] = True
        except AssertionError as e:
            summary[-1]["passed"] = False
            summary[-1]["error"] = str(e)
        summary[-1]["seconds"] = time.perf_counter() - t0
        print(f"run {r}: " + json.dumps(summary[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())
    print(json.dumps(summary))
    return 0 if all(s["passed"] for s in summary) else 1


if __name__ == "__main__":
    sys.exit(main())
