#!/usr/bin/env python3
"""Ask which collectives gloo runs on CUDA tensors, for ranks that share
one card.

DTensor issues its collectives straight to c10d on the tensors it holds
(no staging through host memory, unlike ``distributed/collectives.py``),
so the LM mesh paths over a ``"cuda"`` mesh of gloo ranks work only where
gloo takes device tensors. ``launch.mesh.run_ranks(..., backend="gloo",
device="cuda:0")`` starts the ranks; each tries, one at a time:

* the c10d calls ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
  ``all_reduce``, ``all_to_all_single``, ``broadcast`` and ``barrier``,
  each checked against the values it must deliver;
* DTensor's redistributions on a ("data",) mesh: Shard -> Replicate
  (all-gather), Partial -> Replicate (all-reduce), Partial -> Shard
  (reduce-scatter), Shard(0) -> Shard(1) (all-to-all);
* one FSDP product with its backward: ``x @ w`` with ``w`` sharded on
  its rows and ``x`` on its batch, through ``sharding.mesh_einsum``, the
  gradients checked against the plain product's.

Each runs in a world of its own, since an op that gloo cannot run on a
device tensor may take the rank down (a segfault) rather than raise. It
prints one JSON line: for each, "ok", the error's first line, or how the
world ended.

    python3 tools/gloo_cuda_ops.py [--ranks 2] [--device cuda:0] [--ops a,b]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _try(out: dict, name: str, fn) -> None:
    t0 = time.perf_counter()
    try:
        fn()
        out[name] = "ok"
    except Exception as e:      # the outcome is the finding
        line = (str(e).strip().splitlines() or [""])[0]
        out[name] = f"{type(e).__name__}: {line}"[:300]
    out[name + "_ms"] = (time.perf_counter() - t0) * 1e3


OPS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce",
       "all_to_all_single", "broadcast", "barrier",
       "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
       "dtensor_partial_to_shard", "dtensor_shard0_to_shard1",
       "fsdp_product_backward", "all_gather_into_tensor_2d",
       "functional_all_gather", "dtensor_full_tensor_1d")


def rank_fn(rank: int, n: int, device: str, ops) -> dict:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed.sharding import mesh_einsum

    dev = torch.device(device)
    out = {"rank": rank}

    def check(got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"got {got.flatten()[:4].tolist()}, want "
                                 f"{want.flatten()[:4].tolist()}")

    x = torch.arange(4 * n, dtype=torch.float32, device=dev) + 100 * rank
    every = torch.stack([torch.arange(4 * n, dtype=torch.float32) + 100 * r
                         for r in range(n)])

    def all_gather():
        buf = torch.empty(n * 4 * n, device=dev)
        dist.all_gather_into_tensor(buf, x)
        check(buf, every.flatten())

    def reduce_scatter():
        buf = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(buf, x)
        check(buf, every.sum(0)[4 * rank:4 * rank + 4])

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        check(y, every.sum(0))

    def all_to_all():
        buf = torch.empty(4 * n, device=dev)
        dist.all_to_all_single(buf, x)
        check(buf, every[:, 4 * rank:4 * rank + 4].flatten())

    def broadcast():
        y = x.clone()
        dist.broadcast(y, 0)
        check(y, every[0])

    def all_gather_2d():
        loc = (torch.arange(8, dtype=torch.float32, device=dev)
               + 100 * rank).reshape(4, 2)
        buf = torch.empty(4 * n, 2, device=dev)
        dist.all_gather_into_tensor(buf, loc)
        check(buf, torch.cat([torch.arange(8.).reshape(4, 2) + 100 * r
                              for r in range(n)]))

    def functional_all_gather():
        from torch.distributed import _functional_collectives as funcol
        got = funcol.all_gather_tensor(x, 0, dist.group.WORLD)
        check(funcol.wait_tensor(got), every.flatten())

    def full_tensor_1d():
        mesh = DeviceMesh(dev.type, list(range(n)),
                          mesh_dim_names=("data",))
        d = DTensor.from_local(x, mesh, [Shard(0)])
        check(d.full_tensor(), every.flatten())

    fns = {"all_gather_into_tensor": all_gather,
           "all_gather_into_tensor_2d": all_gather_2d,
           "functional_all_gather": functional_all_gather,
           "dtensor_full_tensor_1d": full_tensor_1d,
           "reduce_scatter_tensor": reduce_scatter, "all_reduce": all_reduce,
           "all_to_all_single": all_to_all, "broadcast": broadcast,
           "barrier": dist.barrier}

    g = torch.Generator().manual_seed(0)
    full = torch.randn(4 * n, 2 * n, generator=g).to(dev)

    def shard_to_replicate():
        mesh = DeviceMesh(dev.type, list(range(n)),
                          mesh_dim_names=("data",))
        d = DTensor.from_local(full.chunk(n)[rank], mesh, [Shard(0)])
        check(d.redistribute(mesh, [Replicate()]).to_local(), full)

    def partial_to_replicate():
        mesh = DeviceMesh(dev.type, list(range(n)),
                          mesh_dim_names=("data",))
        d = DTensor.from_local(full * (rank + 1), mesh, [Partial()])
        check(d.redistribute(mesh, [Replicate()]).to_local(),
              full * sum(range(1, n + 1)))

    def partial_to_shard():
        mesh = DeviceMesh(dev.type, list(range(n)),
                          mesh_dim_names=("data",))
        d = DTensor.from_local(full * (rank + 1), mesh, [Partial()])
        check(d.redistribute(mesh, [Shard(0)]).to_local(),
              (full * sum(range(1, n + 1))).chunk(n)[rank])

    def shard0_to_shard1():
        mesh = DeviceMesh(dev.type, list(range(n)),
                          mesh_dim_names=("data",))
        d = DTensor.from_local(full.chunk(n)[rank], mesh, [Shard(0)])
        check(d.redistribute(mesh, [Shard(1)]).to_local(),
              full.chunk(n, dim=1)[rank])

    def fsdp_product():
        mesh = DeviceMesh(dev.type, list(range(n)),
                          mesh_dim_names=("data",))
        xg = torch.randn(2 * n, 4 * n, generator=g).to(dev)
        wl = full.chunk(n)[rank].clone().requires_grad_(True)
        xl = xg.chunk(n)[rank].clone().requires_grad_(True)
        w = DTensor.from_local(wl, mesh, [Shard(0)])
        xd = DTensor.from_local(xl, mesh, [Shard(0)])
        y = mesh_einsum("bi,io->bo", xd, w)
        loss = y.redistribute(mesh, [Replicate()]).to_local().square().sum()
        loss.backward()
        wf = full.clone().requires_grad_(True)
        xf = xg.clone().requires_grad_(True)
        (xf @ wf).square().sum().backward()
        torch.testing.assert_close(wl.grad, wf.grad.chunk(n)[rank])
        torch.testing.assert_close(xl.grad, xf.grad.chunk(n)[rank])

    fns.update({"dtensor_shard_to_replicate": shard_to_replicate,
                "dtensor_partial_to_replicate": partial_to_replicate,
                "dtensor_partial_to_shard": partial_to_shard,
                "dtensor_shard0_to_shard1": shard0_to_shard1,
                "fsdp_product_backward": fsdp_product})
    for name in ops:
        _try(out, name, fns[name])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--ops", default=",".join(OPS))
    args = ap.parse_args()
    import torch
    from repro_torch.launch.mesh import run_ranks

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("gloo_cuda_ops: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    out = {}
    for op in args.ops.split(","):
        try:
            ranks = run_ranks(rank_fn, args.ranks, args.ranks, args.device,
                              [op], backend="gloo", device=args.device,
                              timeout_s=args.timeout)
            said = {r[op] for r in ranks}
            out[op] = said.pop() if len(said) == 1 else sorted(said)
            out[op + "_ms"] = max(r[op + "_ms"] for r in ranks)
        except Exception as e:   # a rank that died: how the world ended
            out[op] = f"world failed: {type(e).__name__}: " + (
                str(e).splitlines() or [""])[0][:300]
    out.update(n_ranks=args.ranks, device=args.device,
               torch=torch.__version__, wall_s=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
