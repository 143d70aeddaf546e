#!/usr/bin/env python3
"""Try a world of P NCCL ranks that share one card.

The sharded serving path's SPMD executor runs one rank a shard; with one
GPU, ``chip_smoke.py`` phase 18 runs its ranks over gloo, which stages
every payload through host memory. This script asks whether NCCL takes P
ranks on the same device: ``launch.mesh.run_ranks(..., backend="nccl",
device="cuda:0")`` starts them, and each runs the ring exchange
(``collectives.ring_exchange``) and an ``all_gather`` of device tensors and
checks what arrives. It prints one JSON line: that the world ran, with
each rank's seconds, or the error text.

    python3 tools/nccl_one_card.py [--ranks 2] [--timeout 120]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def rank_fn(rank: int, n: int) -> dict:
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import collectives

    t0 = time.perf_counter()
    group = dist.group.WORLD
    x = torch.full((1024, 16), float(rank), device="cuda")
    got = collectives.ring_exchange([x + d for d in range(1, n)], group)
    for d, g in enumerate(got, start=1):
        want = float((rank - d) % n + d)
        if not bool((g == want).all()):
            raise AssertionError(f"shift {d}: got {float(g[0, 0])}, want "
                                 f"{want}")
    rows = collectives.all_gather(x, group)
    if [float(r[0, 0]) for r in rows] != [float(r) for r in range(n)]:
        raise AssertionError("all_gather delivered other rows")
    torch.cuda.synchronize()
    return dict(rank=rank, backend=collectives.backend(group),
                seconds=time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120.0)
    args = ap.parse_args()
    import torch
    from repro_torch.launch.mesh import run_ranks

    if not torch.cuda.is_available():
        print("nccl_one_card: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(rank_fn, args.ranks, args.ranks, backend="nccl",
                          device="cuda:0", timeout_s=args.timeout)
        out = dict(ran=True, ranks=ranks)
    except Exception as e:      # the outcome is the finding
        out = dict(ran=False, error=f"{type(e).__name__}: {e}"[-4000:])
    out.update(n_ranks=args.ranks, devices=torch.cuda.device_count(),
               torch=torch.__version__, nccl=".".join(
                   map(str, torch.cuda.nccl.version())),
               wall_s=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
