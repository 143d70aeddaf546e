#!/usr/bin/env python3
"""Build variants of the fp FRDC kernels and compare their device time.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 tools/fp_variants.py``

Each variant rewrites one constant of ``csrc/walk.cuh`` / the kernels'
``__launch_bounds__`` in a copy under ``src/repro_torch/_build/variants/``
(block warps, a minimum of resident blocks, hits in flight a sub-warp),
builds ``bspmm.cu`` and ``bspmm_grid.cu`` with ``-Xptxas -v`` (registers and
spills printed), and times each build's launch on full Flickr's GCN FRDC at
F = 64 and 7 and at a serve bucket (F = 7, 1D and block (32, 32)): device
ms per launch from torch.profiler, twice, and the max abs error against the
plain version. Nothing here is part of the port.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.graphs.datasets import make_dataset  # noqa: E402
from repro_torch.kernels import bspmm_kernel, build  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.serve import GraphStore, session_core  # noqa: E402

dev = "cuda"
OUT = ROOT / "src" / "repro_torch" / "_build" / "variants"
VARIANTS = {
    "base": {},
    "minb6": {"minb": 6},
    "minb8": {"minb": 8},
    "warps4": {"warps": 4},
    "unroll16": {"unroll": "kCols == 4 ? 8 : 16"},
    "unroll4": {"unroll": "kCols == 4 ? 2 : 4"},
}


def make(name, v):
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    walk = (ROOT / "src/repro_torch/csrc/walk.cuh").read_text()
    if "warps" in v:
        walk = walk.replace("constexpr int kBlockWarps = 8;",
                            f"constexpr int kBlockWarps = {v['warps']};")
    if "unroll" in v:
        walk = walk.replace("static constexpr int kUnroll = kCols == 4 ? 4 : 8;",
                            f"static constexpr int kUnroll = {v['unroll']};")
    (d / "walk.cuh").write_text(walk)
    procs = []
    for src in ("bspmm", "bspmm_grid"):
        s = (ROOT / f"src/repro_torch/csrc/{src}.cu").read_text()
        if "minb" in v:
            s = s.replace("__launch_bounds__(walk::kBlockWarps * 32)",
                          f"__launch_bounds__(walk::kBlockWarps * 32, {v['minb']})")
        (d / f"{src}.cu").write_text(s)
        procs.append(subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(d / f"{src}.so"), str(d / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def device_ms(fn, iters=20):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return round(sum(e.device_time_total for e in p.key_averages()
                     if e.device_type.name == "CUDA") / iters / 1e3, 4)


def main():
    procs = {n: make(n, v) for n, v in VARIANTS.items()}
    libs = {}
    for n, ps in procs.items():
        for src, p in zip(("bspmm", "bspmm_grid"), ps):
            log, _ = p.communicate()
            regs = [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln and "0 bytes" not in ln]
            if p.returncode:
                print(n, src, "FAILED", log[-2000:])
                continue
            print(n, src, regs[:4])
            lib = ctypes.CDLL(str(OUT / n / f"{src}.so"))
            fn = "bspmm_fp" if src == "bspmm" else "bspmm_fp_grid"
            getattr(lib, fn).argtypes = list(build.SIGNATURES[src][fn])
            getattr(lib, fn).restype = ctypes.c_int
            libs[(n, src)] = getattr(lib, fn)
    flickr = make_dataset("flickr", seed=0, scale=1.0)
    n, f_in = flickr.x.shape
    adj = flickr.adjacency("gcn", dev)
    rng = np.random.default_rng(0)
    st = GraphStore(max_batch=32, khop=2, use_pallas=True, device=dev, fused=True)
    st.register_graph("flickr", flickr)
    st.register_model("gcn", "gcn", gnn.init_gcn(0, f_in, 64, flickr.n_classes, dev))
    sess = st.session("flickr", "gcn")
    sess.warmup(np.random.default_rng(0), probes=16)
    seeds = np.random.default_rng(2).integers(0, n, size=(8, 32))
    staged = sess.prepare_batch(seeds[0]).groups[0].staged
    n_pad = staged.x_pad.shape[0]
    a = staged.adjs["adj"]
    adj_b = session_core.frdc_rebuild(
        {k: v.to(dev) for k, v in a.items() if torch.is_tensor(v)}, n_pad,
        n_pad)
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for f in (64, 7):
        x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(dev)
        cases[f"1d F={f}"] = ("bspmm", adj, x, None)
    y = torch.from_numpy(rng.standard_normal((n_pad, 7)).astype(np.float32)).to(dev)
    cases["grid bucket F=7"] = ("bspmm_grid", adj_b, y,
                                bspmm_kernel._block_plan((32, 32), 7, False))
    cases["1d bucket F=7"] = ("bspmm", adj_b, y, None)
    res = {}
    for cname, (src, m, x, plan) in cases.items():
        nn, f = x.shape
        want = bspmm_kernel.bspmm_fp_plain(m, x)
        for vname in VARIANTS:
            fn = libs.get((vname, src))
            if fn is None:
                continue
            _, out, work, tickets = bspmm_kernel._fp_launch_args(m, x, "sweep", plan)
            if plan is None:
                lay = bspmm_kernel.fp_layout(f, f, x.data_ptr())

                def run():
                    build.check(fn(m.grp_ptr.data_ptr(), m.group_row.data_ptr(),
                                   m.tiles.data_ptr(), m.col_idx.data_ptr(),
                                   x.data_ptr(), out.data_ptr(), work.data_ptr(),
                                   tickets, m.n_tile_rows, m.n_groups, nn, f,
                                   lay.sub, lay.cols, int(lay.vec), stream), "v")
            else:
                tb, n_rb, fw, n_fb = bspmm_kernel._grid_geometry(m, plan, f)
                lay = bspmm_kernel.fp_layout(fw, f, x.data_ptr())

                def run():
                    build.check(fn(m.grp_ptr.data_ptr(), m.group_row.data_ptr(),
                                   m.tiles.data_ptr(), m.col_idx.data_ptr(),
                                   x.data_ptr(), out.data_ptr(), work.data_ptr(),
                                   tickets, m.n_tile_rows, m.n_groups, tb, n_rb,
                                   fw, n_fb, nn, f, lay.sub, lay.cols,
                                   int(lay.vec), stream), "v")
            run()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            res[f"{cname} {vname}"] = (device_ms(run), device_ms(run), err)
            print(cname, vname, res[f"{cname} {vname}"], flush=True)
    print(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
