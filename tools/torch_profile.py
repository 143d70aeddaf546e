#!/usr/bin/env python3
"""Where a forward's time goes on the GPU: the PyTorch port's bitgnn
forwards on full-size Flickr (hidden 64, seeded weights, frozen BN stats)
under ``torch.profiler``.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 tools/torch_profile.py``

For each forward it prints the wall time per forward, the device busy time
(sum of kernel times) and the idle share ``1 - busy / wall``, then the
operators with the most device time. Nothing here is part of the port.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HIDDEN = 64
ITERS = 10       # forwards per measurement
TOP = 12         # operators listed per forward


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import build
    from repro_torch.models import gnn

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all()
    d = make_dataset("flickr", seed=0, scale=1.0)
    x = torch.from_numpy(d.x).cuda()
    adj = {k: d.adjacency(k, "cuda") for k in ("gcn", "binary", "mean")}
    f, c = d.x.shape[1], d.n_classes
    runs = {
        "gcn_bin": (gnn.BitGCN(gnn.init_gcn(0, f, HIDDEN, c), "bin"),
                    (adj["gcn"], adj["binary"])),
        "gcn_full": (gnn.BitGCN(gnn.init_gcn(0, f, HIDDEN, c), "full"),
                     (adj["gcn"], adj["binary"])),
        "sage": (gnn.BitSAGE(gnn.init_sage(0, f, HIDDEN, c)), (adj["mean"],)),
        "saint": (gnn.BitSAINT(gnn.init_saint(0, f, HIDDEN, c)),
                  (adj["binary"],)),
    }
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for name, (model, mats) in runs.items():
        _, stats = model(x, *mats, return_bn_stats=True)

        def forward():
            for _ in range(ITERS):
                model(x, *mats, bn_stats=stats)
            torch.cuda.synchronize()

        forward()                       # warm-up
        t0 = time.perf_counter()
        forward()                       # wall time without the profiler
        wall = (time.perf_counter() - t0) / ITERS * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forward()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                t, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
        busy = sum(t for t, _ in by_name.values()) / ITERS / 1e3
        print(f"\n{name}/flickr: wall {wall:.4f} ms per forward, device busy "
              f"{busy:.4f} ms, idle share {1 - busy / wall:.3f}")
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
        for k, (t, n) in top:
            print(f"  {t / ITERS / 1e3:9.4f} ms  {n // ITERS:3d}x  "
                  f"{k[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
