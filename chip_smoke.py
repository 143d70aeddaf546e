#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:  ``python3 chip_smoke.py``

Phases (each raises on failure; the script then exits 1 and prints no
result):

1. build — compile the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel);
2. parity — every kernel against its plain PyTorch version on the card, at
   the shapes the main path gives it and at edge cases (N < 4, tail bits,
   empty tile-rows, a ``pad_frdc``-padded matrix, F = 7). Integer kernels
   must match bit for bit; ``bspmm_fp`` may differ by fp32 summation order,
   within 1e-5 of the sum of |terms| behind each output, plus 1e-6;
3. main path — the paper's binary GNN inference at full width (hidden 64)
   with seeded random weights and BN calibrated on the full graph: GCN
   "bin", GCN "full", GraphSAGE and GraphSAINT on full-size Flickr, GCN
   "bin" on Reddit at scale 0.1. Each card forward is held against the same
   forward on the CPU (plain versions, the card's frozen BN stats): rows of
   logits allclose(rtol = atol = 1e-3) and predictions equal on at least
   99.9% of nodes (a sign taken of a near-zero fp value may flip), and
   every kernel of the path must have launched;
4. times — each kernel's median ms at its main-path shape (CUDA events,
   after warm-up) beside its bound, its plain version and a PyTorch library
   call of the same function where one exists; each forward's ms.

Output: a JSON line with one record per kernel, the card's name and power
limit from nvidia-smi, and last the line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HIDDEN = 64          # the paper's hidden width (benchmarks/bench_gnn_tables.py)
SEED = 0
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
INT8_TC_OPS_PER_S = 1979e12  # lowest-precision tensor-core rate in the table
FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores
FP_TOL, FP_TOL_ABS = 1e-5, 1e-6   # bspmm_fp vs plain, see hold()
ROWS_CLOSE_MIN = 0.999
PRED_AGREE_MIN = 0.999
REPLACES = {
    "binarize_pack": ("src/repro_torch/csrc/pack.cu",
                      "src/repro/kernels/pack_kernel.py:27"),
    "bmm_xnor": ("src/repro_torch/csrc/bmm.cu",
                 "src/repro/kernels/bmm_kernel.py:59"),
    "bspmm_bits": ("src/repro_torch/csrc/bspmm.cu",
                   "src/repro/kernels/bspmm_kernel.py:482"),
    "bspmm_fp": ("src/repro_torch/csrc/bspmm.cu",
                 "src/repro/kernels/bspmm_kernel.py:547"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn`` over ``iters`` launches, each between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def host_ms(torch, fn, iters: int = 5) -> float:
    """Median wall ms of ``fn`` ending in a synchronize, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run(torch) -> dict:
    from repro_torch.core import bitops, frdc
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import bmm_kernel, bspmm_kernel, build, ops
    from repro_torch.kernels import pack_kernel
    from repro_torch.models import gnn
    import numpy as np

    dev = DEVICE
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 BMM.F?? products
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(SEED)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def rand_words(rows, nbits):
        return bitops.pack_bits(card(rng.integers(0, 2, (rows, nbits))))

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(build.SOURCES)} "
        f"sources {build.SOURCES}")

    # -- data ---------------------------------------------------------------
    t0 = time.perf_counter()
    flickr = make_dataset("flickr", seed=SEED, scale=1.0)
    reddit = make_dataset("reddit", seed=SEED, scale=0.1)
    log(f"datasets: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    adjs = {
        "flickr": {k: flickr.adjacency(k, dev) for k in ("gcn", "binary", "mean")},
        "reddit": {k: reddit.adjacency(k, dev) for k in ("gcn", "binary")},
    }
    log(f"FRDC build: {time.perf_counter() - t0:.1f} s")
    for name, d in (("flickr", flickr), ("reddit", reddit)):
        a = adjs[name]["binary"]
        log(f"{name}: nodes {d.n_nodes} edges {d.n_edges} feats "
            f"{d.x.shape[1]} classes {d.n_classes} groups(binary) "
            f"{a.n_groups} groups(gcn) {adjs[name]['gcn'].n_groups}")

    # -- 2. parity ----------------------------------------------------------
    err = {k: 0.0 for k in REPLACES}

    def bits_of(t, n):
        return bitops.unpack_bits(t, n).to(torch.int64)

    def hold(kernel, got, want, n_bits=None, magnitude=None):
        """Bit-exact, or, given ``magnitude`` (the sum of |terms| behind each
        fp output), within FP_TOL of it: reordering an fp32 sum moves it by
        a few ulps of the magnitudes summed, not of the result."""
        if n_bits is not None:
            got, want = bits_of(got, n_bits), bits_of(want, n_bits)
        if got.shape != want.shape:
            raise AssertionError(f"{kernel}: shape {tuple(got.shape)} vs "
                                 f"{tuple(want.shape)}")
        diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
        e = float(diff.max()) if diff.numel() else 0.0
        err[kernel] = max(err[kernel], e)
        if magnitude is None and e != 0.0:
            raise AssertionError(f"{kernel}: not bit-exact, max err {e}")
        if magnitude is not None and bool(
                (diff > FP_TOL * magnitude + FP_TOL_ABS).any()):
            raise AssertionError(f"{kernel}: max err {e} beyond "
                                 f"{FP_TOL} x sum|terms| + {FP_TOL_ABS}")

    n_fl, f_fl = flickr.x.shape
    n_rd, f_rd = reddit.x.shape
    cases = 0
    for m, f, dt in [(n_fl, f_fl, torch.float32), (n_fl, HIDDEN, torch.float32),
                     (n_rd, f_rd, torch.float32), (n_fl, f_fl, torch.bfloat16),
                     (HIDDEN, f_fl, torch.float32), (3, 7, torch.float32),
                     (1, 33, torch.bfloat16)]:
        x = card(rng.standard_normal((m, f)).astype(np.float32)).to(dt)
        hold("binarize_pack", pack_kernel.binarize_pack_cuda(x),
             pack_kernel.binarize_pack_plain(x), n_bits=f)
        cases += 1
    for m, n, k in [(n_fl, HIDDEN, f_fl), (n_fl, flickr.n_classes, HIDDEN),
                    (n_fl, HIDDEN, HIDDEN), (n_rd, reddit.n_classes, HIDDEN),
                    (3, 33, 65), (1, 1, 7)]:
        a, b = rand_words(m, k), rand_words(n, k)
        hold("bmm_xnor", bmm_kernel.bmm_xnor_cuda(a, b, k),
             bmm_kernel.bmm_xnor_plain(a, b, k))
        hold("bmm_xnor", bmm_kernel.bmm_xnor_cuda(a, b, k, True),
             bmm_kernel.bmm_xnor_plain(a, b, k, True), n_bits=n)
        cases += 2
    # edge cases: N < 4, empty tile-rows (bottom half of the graph has no
    # edges), a pad_frdc-padded matrix, tail bits (F = 7, 100)
    small = (rng.random((40, 40)) < 0.2).astype(np.float32)
    small[20:] = 0
    edge_adjs = [frdc.from_dense(np.ones((3, 3), np.float32), device=dev),
                 frdc.from_dense(small, device=dev)]
    edge_adjs.append(frdc.pad_frdc(edge_adjs[1], 64,
                                   n_groups=edge_adjs[1].n_groups + 7))
    bits_cases = [(adjs["flickr"]["binary"], HIDDEN),
                  (adjs["reddit"]["binary"], HIDDEN)]
    bits_cases += [(a, f) for a in edge_adjs for f in (7, 100)]
    for adj, f in bits_cases:
        x = rand_words(adj.n_cols, f)
        for binz in (False, True):
            for mode in ("s3_two_popc", "s2_and_andnot"):
                got = bspmm_kernel.bspmm_bits_cuda(adj, x, f, binz, mode)
                want = bspmm_kernel.bspmm_bits_plain(adj, x, f, binz, mode)
                hold("bspmm_bits", got, want, n_bits=f if binz else None)
                cases += 1
    fp_cases = [(adjs["flickr"][k], f) for k in ("gcn", "mean", "binary")
                for f in (HIDDEN, flickr.n_classes)]
    fp_cases += [(adjs["reddit"]["gcn"], reddit.n_classes)]
    fp_cases += [(a, f) for a in edge_adjs for f in (7, 100)]
    for adj, f in fp_cases:
        x = card(rng.standard_normal((adj.n_cols, f)).astype(np.float32))
        hold("bspmm_fp", bspmm_kernel.bspmm_fp_cuda(adj, x),
             bspmm_kernel.bspmm_fp_plain(adj, x),
             magnitude=bspmm_kernel.bspmm_fp_plain(adj, x.abs()))
        cases += 1
    torch.cuda.synchronize()
    log(f"parity: {cases} cases passed; max abs err "
        + json.dumps({k: v for k, v in err.items()}))

    # -- 3. main path -------------------------------------------------------
    xs = {"flickr": card(flickr.x), "reddit": card(reddit.x)}
    models = {
        "gcn_bin/flickr": (gnn.BitGCN(gnn.init_gcn(
            SEED, f_fl, HIDDEN, flickr.n_classes, dev), scheme="bin"),
            "flickr", ("gcn", "binary")),
        "gcn_full/flickr": (gnn.BitGCN(gnn.init_gcn(
            SEED, f_fl, HIDDEN, flickr.n_classes, dev), scheme="full"),
            "flickr", ("gcn", "binary")),
        "sage/flickr": (gnn.BitSAGE(gnn.init_sage(
            SEED, f_fl, HIDDEN, flickr.n_classes, dev)), "flickr", ("mean",)),
        "saint/flickr": (gnn.BitSAINT(gnn.init_saint(
            SEED, f_fl, HIDDEN, flickr.n_classes, dev)), "flickr", ("binary",)),
        "gcn_bin/reddit": (gnn.BitGCN(gnn.init_gcn(
            SEED, f_rd, HIDDEN, reddit.n_classes, dev), scheme="bin"),
            "reddit", ("gcn", "binary")),
    }
    expected = {"gcn_bin": {"binarize_pack", "bmm_xnor", "bspmm_bits",
                            "bspmm_fp"},
                "gcn_full": {"binarize_pack", "bmm_xnor", "bspmm_fp"},
                "sage": {"binarize_pack", "bmm_xnor", "bspmm_fp"},
                "saint": {"binarize_pack", "bmm_xnor", "bspmm_fp"}}
    launches = {k: 0 for k in REPLACES}
    forward_ms = {}
    for name, (model, ds, kinds) in models.items():
        x = xs[ds]
        mats = [adjs[ds][k] for k in kinds]
        ops.reset_launch_counts()
        logits, stats = model(x, *mats, return_bn_stats=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        for k, v in counts.items():
            launches[k] += v
        missing = [k for k in expected[name.split("/")[0]] if counts[k] == 0]
        if missing:
            raise AssertionError(f"{name}: kernels never launched: {missing}")
        n, c = x.shape[0], {"flickr": flickr, "reddit": reddit}[ds].n_classes
        if tuple(logits.shape) != (n, c) or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{name}: logits {tuple(logits.shape)} not "
                                 f"finite of shape ({n}, {c})")
        forward_ms[name] = host_ms(
            torch, lambda: model(x, *mats, bn_stats=stats))
        # the same forward on the CPU: plain versions, the card's BN stats
        cpu_stats = tuple((mu.cpu(), sd.cpu()) for mu, sd in stats)
        want = model.to("cpu")(x.cpu(), *[m.to("cpu") for m in mats],
                               bn_stats=cpu_stats)
        model.to(dev)
        got = logits.cpu()
        rows_close = float(torch.isclose(got, want, rtol=1e-3, atol=1e-3)
                           .all(dim=1).float().mean())
        agree = int((got.argmax(1) == want.argmax(1)).sum())
        log(f"forward {name}: {forward_ms[name]:.3f} ms; launches {counts}; "
            f"vs CPU: rows close {rows_close:.6f}, predictions agree "
            f"{agree}/{n}, max |dlogit| {float((got - want).abs().max()):.3e}")
        if rows_close < ROWS_CLOSE_MIN or agree < PRED_AGREE_MIN * n:
            raise AssertionError(f"{name}: card and CPU forwards disagree")
    for k, v in launches.items():
        if v == 0:
            raise AssertionError(f"kernel {k} never launched on the main path")
    log(f"main path launches: {json.dumps(launches)}")

    # -- 4. times at the main-path shapes ------------------------------------
    adj_b, adj_g = adjs["flickr"]["binary"], adjs["flickr"]["gcn"]
    x500 = card(rng.standard_normal((n_fl, f_fl)).astype(np.float32))
    wk = bitops.padded_words(f_fl)
    a_w, b_w = rand_words(n_fl, f_fl), rand_words(HIDDEN, f_fl)
    h_w = rand_words(n_fl, HIDDEN)
    h_fp = card(rng.standard_normal((n_fl, HIDDEN)).astype(np.float32))
    a_pm1 = (2 * card(rng.integers(0, 2, (n_fl, f_fl))) - 1).to(torch.bfloat16)
    b_pm1 = (2 * card(rng.integers(0, 2, (f_fl, HIDDEN))) - 1).to(torch.bfloat16)
    r, c = flickr.edges
    loops = np.arange(n_fl)
    rows = np.concatenate([r, loops])
    cols = np.concatenate([c, loops])
    csr = torch.sparse_coo_tensor(card(np.stack([rows, cols])),
                                  torch.ones(rows.size, device=dev),
                                  (n_fl, n_fl)).coalesce().to_sparse_csr()
    r4 = adj_b.n_tile_rows * 4

    def group_bytes(adj):
        return 4 * (adj.grp_ptr.numel() + adj.tiles.numel() + adj.col_idx.numel())

    def bound(nbytes, nops, rate):
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / rate * 1e3
        return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")

    specs = {
        "binarize_pack": (
            f"x ({n_fl}, {f_fl}) float32 -> ({n_fl}, {wk}) words",
            lambda: pack_kernel.binarize_pack_cuda(x500),
            lambda: pack_kernel.binarize_pack_plain(x500), None,
            bound(4 * n_fl * f_fl + 4 * n_fl * wk, n_fl * f_fl, FP32_OPS_PER_S)),
        "bmm_xnor": (
            f"A ({n_fl}, {wk}) x B ({HIDDEN}, {wk}) words, K={f_fl} -> "
            f"({n_fl}, {HIDDEN}) int32",
            lambda: bmm_kernel.bmm_xnor_cuda(a_w, b_w, f_fl),
            lambda: bmm_kernel.bmm_xnor_plain(a_w, b_w, f_fl),
            lambda: torch.matmul(a_pm1, b_pm1),
            bound(4 * (n_fl + HIDDEN) * wk + 4 * n_fl * HIDDEN,
                  2 * n_fl * HIDDEN * f_fl, INT8_TC_OPS_PER_S)),
        "bspmm_bits": (
            f"flickr 0/1 FRDC ({adj_b.n_groups} groups, {adj_b.nnz} edges) x "
            f"({n_fl}, 2) words -> ({r4}, {HIDDEN}) int32 counts, s3",
            lambda: bspmm_kernel.bspmm_bits_cuda(adj_b, h_w, HIDDEN, False),
            lambda: bspmm_kernel.bspmm_bits_plain(adj_b, h_w, HIDDEN, False),
            None,
            bound(group_bytes(adj_b) + 4 * h_w.numel() + 4 * r4 * HIDDEN,
                  2 * adj_b.nnz * HIDDEN, INT8_TC_OPS_PER_S)),
        "bspmm_fp": (
            f"flickr GCN FRDC ({adj_g.n_groups} groups, {adj_g.nnz} edges) x "
            f"({n_fl}, {HIDDEN}) float32 -> ({r4}, {HIDDEN}), raw",
            lambda: bspmm_kernel.bspmm_fp_cuda(adj_g, h_fp),
            lambda: bspmm_kernel.bspmm_fp_plain(adj_g, h_fp),
            lambda: torch.sparse.mm(csr, h_fp),
            bound(group_bytes(adj_g) + 4 * n_fl * HIDDEN + 4 * r4 * HIDDEN,
                  2 * adj_g.nnz * HIDDEN, FP32_OPS_PER_S)),
    }
    records = []
    for name, (shape, kern, plain, lib, (b_ms, b_by)) in specs.items():
        ms = cuda_ms(torch, kern)
        plain_ms = cuda_ms(torch, plain, iters=5, warmup=1)
        lib_ms = cuda_ms(torch, lib) if lib is not None else None
        source, replaces = REPLACES[name]
        rec = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}
        records.append(rec)
        log(f"time {name} [{shape}]: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), library "
            f"{'null' if lib_ms is None else f'{lib_ms:.4f} ms'}")
    # the high-degree case of the reddit run, printed beside the record
    adj_r = adjs["reddit"]["binary"]
    h_r = rand_words(n_rd, HIDDEN)
    log(f"time bspmm_bits reddit-0.1 [{adj_r.n_groups} groups, {adj_r.nnz} "
        f"edges]: kernel "
        f"{cuda_ms(torch, lambda: bspmm_kernel.bspmm_bits_cuda(adj_r, h_r, HIDDEN, False)):.4f}"
        f" ms, bound {bound(group_bytes(adj_r) + 4 * h_r.numel() + 4 * adj_r.n_tile_rows * 4 * HIDDEN, 2 * adj_r.nnz * HIDDEN, INT8_TC_OPS_PER_S)[0]:.4f} ms")
    log("forward ms: " + json.dumps(forward_ms))
    return {"kernels": records}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found; run from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    result = run(torch)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(json.dumps(result), flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
