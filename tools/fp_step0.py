#!/usr/bin/env python3
"""Where the fp FRDC kernels of the per-bit walk spent their time: the
measurement taken before the edge-driven walk replaced them.

It runs against a tree that still has the per-bit walk (the commit before
that change, unpacked with ``git archive`` into a directory that
``.gitignore`` lists), on a machine with one NVIDIA GPU:

    python3 tools/fp_step0.py --tree scratch_chip/parent

1. ``fp_grid_kernel`` at the serve bucket (F = 7, block (32, 32)): the whole
   kernel against a copy of its source without the heavy-row loop (tile-rows
   of more than ``kHeavy`` groups are skipped), each timed twice in turns;
2. ``bspmm_fp`` on full Flickr's GCN FRDC at F = 64, 32 and 7 (the
   wrapper) against ``torch.sparse.mm`` at the same shapes;
3. ptxas' register counts.
"""
import ctypes
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(sys.argv[sys.argv.index("--tree") + 1]).resolve() \
    if "--tree" in sys.argv else Path(__file__).resolve().parents[1]
HERE = ROOT / "src" / "repro_torch" / "_build" / "step0"
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.graphs.datasets import make_dataset  # noqa: E402
from repro_torch.kernels import bspmm_kernel, build  # noqa: E402
from repro_torch.serve import GraphStore, session_core  # noqa: E402
from repro_torch.models import gnn  # noqa: E402

GRID_KERNEL = ("__global__ void __launch_bounds__(kWarps * 32)\n"
               "    fp_grid_kernel")
HEAVY_LOOP = "  for (int tr = tr0; tr < tr1; ++tr) {"


def grid_without_heavy_rows() -> Path:
    """The tree's bspmm_grid.cu with fp_grid_kernel's heavy-row loop cut."""
    src = (ROOT / "src/repro_torch/csrc/bspmm_grid.cu").read_text()
    if GRID_KERNEL not in src:
        sys.exit("fp_step0: this tree has no per-bit fp_grid_kernel; pass "
                 "--tree with a checkout from before the edge-driven walk")
    start = src.index(GRID_KERNEL)
    heavy = src.index(HEAVY_LOOP, start)
    end = src.index("}  // namespace", heavy)
    HERE.mkdir(parents=True, exist_ok=True)
    out = HERE / "grid_skip.cu"
    out.write_text(src[:heavy] + "}\n\n" + src[end:])
    return out

SEED = 0
dev = "cuda"


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main():
    t0 = time.perf_counter()
    build.build_all()
    nvcc = build.nvcc_path()
    csrc = ROOT / "src/repro_torch/csrc"
    skip_so = HERE / "grid_skip.so"
    subprocess.run([nvcc, *build.NVCC_FLAGS, "-I", str(csrc), "-o",
                    str(skip_so), str(grid_without_heavy_rows())], check=True)
    for name in ("bspmm", "bspmm_grid", "fused_layer"):
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o",
                            "/dev/null", str(csrc / f"{name}.cu")],
                           capture_output=True, text=True)
        for line in (r.stdout + r.stderr).splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"ptxas {name}: {line.strip()}")
    skip = ctypes.CDLL(str(skip_so))
    skip.bspmm_fp_grid.argtypes = list(build.SIGNATURES["bspmm_grid"]["bspmm_fp_grid"])
    skip.bspmm_fp_grid.restype = ctypes.c_int
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)

    flickr = make_dataset("flickr", seed=SEED, scale=1.0)
    n, f_in = flickr.x.shape
    adj = flickr.adjacency("gcn", dev)
    rng = np.random.default_rng(SEED)
    res = {}

    # -- 1D bspmm_fp on full Flickr ------------------------------------
    r, c = flickr.edges
    loops = np.arange(n)
    rows = np.concatenate([r, loops])
    cols = np.concatenate([c, loops])
    csr = torch.sparse_coo_tensor(torch.from_numpy(np.stack([rows, cols])).to(dev),
                                  torch.ones(rows.size, device=dev),
                                  (n, n)).coalesce().to_sparse_csr()
    print(f"flickr gcn: groups {adj.n_groups} tile-rows {adj.n_tile_rows} "
          f"nnz {adj.nnz}", flush=True)
    for f in (64, 32, 7):
        x = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32)).to(dev)
        want = bspmm_kernel.bspmm_fp_plain(adj, x)
        err = float((bspmm_kernel.bspmm_fp_cuda(adj, x) - want).abs().max())
        for turn in range(2):
            res[f"1d F={f} wrapper #{turn}"] = cuda_ms(
                lambda: bspmm_kernel.bspmm_fp_cuda(adj, x))
            res[f"1d F={f} torch.sparse.mm #{turn}"] = cuda_ms(
                lambda: torch.sparse.mm(csr, x))
        res[f"1d F={f} max err"] = err
        print(json.dumps({k: v for k, v in res.items() if f"F={f} " in k}),
              flush=True)

    # -- grid at the serve bucket --------------------------------------
    st = GraphStore(max_batch=32, khop=2, use_pallas=True, device=dev,
                    fused=True)
    st.register_graph("flickr", flickr)
    st.register_model("gcn", "gcn", gnn.init_gcn(SEED, f_in, 64,
                                                 flickr.n_classes, dev))
    sess = st.session("flickr", "gcn")
    sess.warmup(np.random.default_rng(SEED), probes=16)
    seeds = np.random.default_rng(SEED + 2).integers(0, n, size=(8, 32))
    staged = sess.prepare_batch(seeds[0]).groups[0].staged
    n_pad = staged.x_pad.shape[0]
    a = staged.adjs["adj"]
    adj_b = session_core.frdc_rebuild(
        {k: v.to(dev) for k, v in a.items() if torch.is_tensor(v)}, n_pad,
        n_pad)
    gp = adj_b.grp_ptr.cpu().numpy()
    per = np.diff(gp)
    heavy = per > 32
    print(f"bucket: rows {n_pad} groups real {gp[-1]} padded {adj_b.n_groups}; "
          f"heavy tile-rows {int(heavy.sum())} holding {int(per[heavy].sum())} "
          f"groups; largest {int(per.max())}", flush=True)
    f = flickr.n_classes
    y = torch.from_numpy(rng.standard_normal((n_pad, f)).astype(np.float32)).to(dev)
    plan = bspmm_kernel._block_plan((32, 32), f, False)
    tb_rows, n_rb, fw, n_fb = bspmm_kernel._grid_geometry(adj_b, plan, f)
    out = torch.empty((adj_b.n_tile_rows * 4, f), device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def skipped():
        build.check(skip.bspmm_fp_grid(
            adj_b.grp_ptr.data_ptr(), adj_b.tiles.data_ptr(),
            adj_b.col_idx.data_ptr(), y.data_ptr(), out.data_ptr(),
            adj_b.n_tile_rows, tb_rows, n_rb, fw, n_fb, n_pad, f, stream), "skip")

    def whole():
        return bspmm_kernel.bspmm_fp_grid_cuda(adj_b, y, plan)

    for turn in range(2):
        res[f"grid whole #{turn}"] = cuda_ms(whole)
        res[f"grid heavy skipped #{turn}"] = cuda_ms(skipped)
        res[f"grid heavy skipped b #{turn}"] = cuda_ms(skipped)
        res[f"grid whole b #{turn}"] = cuda_ms(whole)
    for f2 in (7, 64):
        y2 = torch.from_numpy(rng.standard_normal((n_pad, f2)).astype(np.float32)).to(dev)
        res[f"1d at bucket F={f2}"] = cuda_ms(lambda: bspmm_kernel.bspmm_fp_cuda(adj_b, y2))
    print(json.dumps(res, indent=1), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
