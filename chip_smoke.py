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
   empty tile-rows, a ``pad_frdc``-padded matrix, F = 7; the bits kernels
   also at F = 160 and on an x one word past its buffer's start, where
   their walk takes no vector loads; ``bmm_xnor`` at
   the tile edges M in {1, 15, 16, 17, 89,250}, K in {7, 255, 256, 257,
   500}, N in {1, 7, 8, 33, 64}, which take both of its routes). Integer
   kernels must match bit for bit; ``bspmm_fp`` may differ by fp32
   summation order, within 1e-5 of the sum of |terms| behind each output,
   plus 1e-6;
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
   call of the same function where one exists (``bspmm_fp`` also at F = 7,
   every layer 2's width; ``bspmm_bits`` beside ``torch.sparse.mm`` of its
   0/1 CSR with the +-1 features as float32, which gives the same counts
   and is held equal to them, on Flickr and on Reddit x0.1; ``bmm_xnor`` at
   each distinct shape the
   forwards give it, beside a bf16 ``torch.matmul`` of the unpacked +-1
   operands); each forward's ms; device ms (torch.profiler) of the BSpMM
   kernels and their yardsticks; registers, static and dynamic shared
   memory and resident blocks per SM of the BSpMM kernels and of
   ``bmm_xnor``;
5. serve parity — the 2D block-grid BSpMM kernels and the fused per-layer
   kernel against their plain versions on the card at the serve bucket's
   shapes (and the fused layer kinds also against the unfused layer
   composition on the CPU), at the edge cases, and against a second run
   (bit-equal);
6. serving — ``GraphStore(max_batch=32, khop=2, use_pallas=True)`` on full
   Flickr at hidden 64: GCN "bin" three ways, (a) the 1D kernels, (b)
   ``bspmm_block=(32, 32)``, (c) ``fused=True``, each warmed up and then
   answering 8 batches of 32 seeded seeds through ``serve_subgraph``, and
   SAGE and SAINT fused for 2 batches each. Each batch is held against the
   card's full-graph forward and the same seeds served on the CPU (plain
   versions, the card's frozen BN), the ways against each other; no new
   program after warmup; (b) launches the grid kernels and no 1D BSpMM,
   (c) one fused launch per layer and nothing else; an artifact saved from
   (a) restores into a new store and serves the same answers;
7. serve times — the grid and fused kernels at the bucket (the bits grid
   also at a full-width block and on device time, beside the
   ``torch.sparse.mm`` yardstick; the fused
   layer also per kind, whole and transform-only, beside its yardstick:
   fp32 ``torch.matmul(z, w_eff)`` for ``gcn_bin_l1``, a bf16
   ``torch.matmul`` for the BBF kinds, and its bound), their registers,
   shared memory and occupancy, per-batch
   ``serve_subgraph`` p50 / p90 and its extract / launch + finish split,
   and the full-graph forward behind ``full_logits``;
8. sharded path — full Flickr at hidden 64 cut into P = 4 shards on the
   one card (``ShardPlanner``), served by ``ShardedGraphSession`` with the
   host layer executor: the distributed full pass of GCN "bin" unfused
   (the 1D kernels) and fused, and of GCN "full", SAGE and SAINT fused
   (each layer one fused launch with the intra+halo pair); routed
   ``serve_subgraph`` of 4 batches of 32 seeded seeds on the GCN "bin"
   session (from ``GraphStore.sharded_session``). Every kernel of the path
   and each sharded form of the fused layer must have launched;
9. sharded checks — each pass against the card's single-host full-graph
   forward under the same frozen BN (the rule of phase 3); GCN "bin"
   fused against unfused, and its layer-1 words: equal except on rows
   that aggregate a neighbour whose transform bit differs between cuBLAS
   and the fused kernel's fmaf chain, where that bit's fp64 value must lie
   within 1e-5 of its sum of |terms| from zero; every owner group of the
   routed batches bit-exact against the single-host card session of way
   (a), no program added after warmup; an artifact round trip through
   ``save`` / ``load``, bit-exact;
10. sharded times — each pass's host ms, halo bytes and launches a pass,
   the routed batch's p50 / p90 and extract split, and each sharded form
   of the fused layer (rows 7e-7h) at shard 0's padded shapes against its
   plain version (sign words bit-exact, fp within FP_TOL of the sum of
   |terms|), with its bound, on events and device time.

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
    "bspmm_bits_grid": ("src/repro_torch/csrc/bspmm_grid.cu",
                        "src/repro/kernels/bspmm_kernel.py:435"),
    "bspmm_fp_grid": ("src/repro_torch/csrc/bspmm_grid.cu",
                      "src/repro/kernels/bspmm_kernel.py:406"),
    "fused_layer": ("src/repro_torch/csrc/fused_layer.cu",
                    "src/repro/kernels/fused_layer.py:163"),
}
# the fused layer's sharded forms (rows 7e-7h): each kind with its halo
# pair, and fc with BN by the reciprocal
PAIR_KINDS = ("gcn_bin_l1+halo", "gcn_bbf_fbf+halo", "branch_add+halo",
              "fc+rcp")
REPLACES.update({f"fused_layer/{k}": REPLACES["fused_layer"]
                 for k in PAIR_KINDS})
FORWARD_KERNELS = ("binarize_pack", "bmm_xnor", "bspmm_bits", "bspmm_fp")
SERVE_KERNELS = ("bspmm_bits_grid", "bspmm_fp_grid", "fused_layer")
GRID_BLOCK = (32, 32)      # the (b) plan's bspmm_block
SERVE_BATCH = 32           # seeds per serve_subgraph call (max_batch)
SERVE_BATCHES = 8          # batches per GCN way; SAGE and SAINT take 2
WARMUP_PROBES = 16
SHARDS = 4                 # the sharded phase's P, all on the one card
ROUTED_BATCHES = 4         # routed serve batches of SERVE_BATCH seeds
ROUTED_PROBES = 2          # warmup probes of the sharded session
ENGINE_BATCHES = 8         # phase 11: batches of SERVE_BATCH per engine run
ENGINE_PROBES = 4          # warmup probes of each engine run
QPS_BATCHES = 4            # batches of each traced / untraced QPS run
ROUTED_QUERIES = 128       # phase 12: queries to the sharded engine
# the distributed passes: name -> (family, scheme, fused)
SHARDED_WAYS = {"gcn_bin/unfused": ("gcn", "bin", False),
                "gcn_bin/fused": ("gcn", "bin", True),
                "gcn_full/fused": ("gcn", "full", True),
                "sage/fused": ("sage", "fixed", True),
                "saint/fused": ("saint", "fixed", True)}


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


def device_ms(torch, fn, iters: int = 20) -> float:
    """Mean device ms a call of ``fn`` spends in kernels and memsets
    (torch.profiler), after one warm-up: unlike ``cuda_ms`` it leaves out
    the time the card waits for the host between launches. The profiler
    can lose kernel records (seen in a process that had loaded several
    builds of one kernel), so each kernel counts its mean over the
    launches recorded, times its launches a call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            t = e.device_time_total if hasattr(e, "device_time_total") \
                else e.cuda_time_total
            total += t / e.count * max(1, round(e.count / iters))
    return total / 1e3


def hold_to(torch, err, kernel, got, want, n_bits=None, magnitude=None):
    """Bit-exact, or, given ``magnitude`` (the sum of |terms| behind each fp
    output), within FP_TOL of it: reordering an fp32 sum moves it by a few
    ulps of the magnitudes summed, not of the result. Records the max abs
    error of ``kernel`` in ``err``."""
    from repro_torch.core import bitops
    if n_bits is not None:
        got = bitops.unpack_bits(got, n_bits).to(torch.int64)
        want = bitops.unpack_bits(want, n_bits).to(torch.int64)
    if got.shape != want.shape:
        raise AssertionError(f"{kernel}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}")
    diff = (got.to(torch.float64).cpu() - want.to(torch.float64).cpu()).abs()
    e = float(diff.max()) if diff.numel() else 0.0
    err[kernel] = max(err[kernel], e)
    if magnitude is None and e != 0.0:
        raise AssertionError(f"{kernel}: not bit-exact, max err {e}")
    if magnitude is not None and bool(
            (diff > FP_TOL * magnitude.to(torch.float64).cpu()
             + FP_TOL_ABS).any()):
        raise AssertionError(f"{kernel}: max err {e} beyond "
                             f"{FP_TOL} x sum|terms| + {FP_TOL_ABS}")


def bound(nbytes, ops_times) -> tuple:
    """(least ms, "bytes" | "operations"): the bytes over the memory rate
    against the operations over their type's peak rate (summed over
    ``ops_times``, pairs of (operations, rate))."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = sum(n / rate for n, rate in ops_times) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def real_groups(adj) -> int:
    """Groups inside the grp_ptr ranges: what a walk visits (the pad_frdc
    groups of a serve bucket lie past grp_ptr[-1] and are never read)."""
    return int(adj.grp_ptr[-1])


def group_bytes(adj) -> int:
    """Bytes of the FRDC arrays a walk reads: grp_ptr, and the int32 tiles
    and col_idx rows (8 words each) of the real groups."""
    return 4 * adj.grp_ptr.numel() + 2 * 8 * 4 * real_groups(adj)


def frdc_csr(torch, adj):
    """The 0/1 pattern of an FRDC matrix as a CSR tensor of float32 ones on
    its device, (n_tile_rows * 4, n_cols), decoded from the tiles of its
    real groups: ``torch.sparse.mm`` of it with +-1 features as float32
    gives the bits kernels' trinary counts (integers below 2^24, exact)."""
    tiles = adj.tiles[:real_groups(adj)]
    gi, ti = torch.nonzero(tiles, as_tuple=True)
    t = tiles[gi, ti]
    rows, cols = [], []
    for i in range(4):
        for j in range(4):
            hit = ((t >> (4 * i + j)) & 1).bool()
            rows.append(adj.group_row[gi[hit]].long() * 4 + i)
            cols.append(adj.col_idx[gi[hit], ti[hit]].long() * 4 + j)
    idx = torch.stack([torch.cat(rows), torch.cat(cols)])
    return torch.sparse_coo_tensor(
        idx, torch.ones(idx.shape[1], device=idx.device),
        (adj.n_tile_rows * 4, adj.n_cols)).coalesce().to_sparse_csr()


def bits_yardstick(torch, bitops, adj, x, n_feat, counts):
    """(call, operand) of the bits kernels' library yardstick, after holding
    its result equal to the kernel's ``counts``."""
    csr = frdc_csr(torch, adj)
    pm1 = bitops.unpack_pm1(x, n_feat).contiguous()
    got = torch.sparse.mm(csr, pm1)
    if not torch.equal(got, counts.to(torch.float32)):
        raise AssertionError("bits yardstick: torch.sparse.mm differs from "
                             "the kernel's counts")
    return lambda: torch.sparse.mm(csr, pm1)


def agree(what, got, want) -> None:
    """The rule of phase 3 on host logits: rows allclose(rtol = atol =
    1e-3) and predictions equal, each on at least 99.9% of rows."""
    import numpy as np
    close = float(np.isclose(got, want, rtol=1e-3, atol=1e-3)
                  .all(axis=1).mean())
    same = float((got.argmax(1) == want.argmax(1)).mean())
    log(f"agree {what}: rows close {close:.6f}, predictions {same:.6f}, "
        f"max |dlogit| {float(np.abs(got - want).max()):.3e}")
    if close < ROWS_CLOSE_MIN or same < PRED_AGREE_MIN:
        raise AssertionError(f"{what}: answers disagree")


def run(torch) -> dict:
    from repro_torch.core import bitops, frdc
    from repro_torch.graphs.datasets import make_dataset
    from repro_torch.kernels import bmm_kernel, bspmm_kernel, build, ops
    from repro_torch.kernels import pack_kernel
    from repro_torch.models import gnn
    import numpy as np

    dev = DEVICE
    t_start = time.perf_counter()
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
    t0 = time.perf_counter()
    err = {k: 0.0 for k in REPLACES}

    def hold(kernel, got, want, n_bits=None, magnitude=None):
        hold_to(torch, err, kernel, got, want, n_bits, magnitude)

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
    # bmm_xnor's tile edges (N <= 8 runs the simt route, wider N the mma one)
    for m in (1, 15, 16, 17, n_fl):
        for k in (7, 255, 256, 257, 500):
            for n in (1, 7, 8, 33, 64):
                a, b = rand_words(m, k), rand_words(n, k)
                for binz in (False, True):
                    hold("bmm_xnor", bmm_kernel.bmm_xnor_cuda(a, b, k, binz),
                         bmm_kernel.bmm_xnor_plain(a, b, k, binz),
                         n_bits=n if binz else None)
                    cases += 1
    # edge cases: N < 4, empty tile-rows (bottom half of the graph has no
    # edges), a pad_frdc-padded matrix, tail bits (F = 7, 100)
    small = (rng.random((40, 40)) < 0.2).astype(np.float32)
    small[20:] = 0
    edge_adjs = [frdc.from_dense(np.ones((3, 3), np.float32), device=dev),
                 frdc.from_dense(small, device=dev)]
    edge_adjs.append(frdc.pad_frdc(edge_adjs[1], 64,
                                   n_groups=edge_adjs[1].n_groups + 7))
    # (adjacency, F, words x's base lies past its buffer's start)
    bits_cases = [(adjs["flickr"]["binary"], HIDDEN, 0),
                  (adjs["flickr"]["binary"], HIDDEN, 1),
                  (adjs["reddit"]["binary"], HIDDEN, 0)]
    bits_cases += [(a, f, 0) for a in edge_adjs for f in (7, 100, 160)]
    for adj, f, off in bits_cases:
        wf = bitops.padded_words(f)
        x = rand_words(adj.n_cols + 1, f).reshape(-1)[
            off:off + adj.n_cols * wf].view(adj.n_cols, wf)
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
    log(f"parity: {cases} cases passed in {time.perf_counter() - t0:.1f} s; "
        f"max abs err "
        + json.dumps({k: v for k, v in err.items()}))

    # -- 3. main path -------------------------------------------------------
    t0 = time.perf_counter()
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
    launches = {k: 0 for k in FORWARD_KERNELS}
    forward_ms = {}
    for name, (model, ds, kinds) in models.items():
        x = xs[ds]
        mats = [adjs[ds][k] for k in kinds]
        ops.reset_launch_counts()
        logits, stats = model(x, *mats, return_bn_stats=True)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items()
                  if k in FORWARD_KERNELS}
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
    log(f"main path launches: {json.dumps(launches)}; "
        f"{time.perf_counter() - t0:.1f} s")

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
    bits_lib = bits_yardstick(torch, bitops, adj_b, h_w, HIDDEN,
                              bspmm_kernel.bspmm_bits_cuda(adj_b, h_w, HIDDEN, False))

    specs = {
        "binarize_pack": (
            f"x ({n_fl}, {f_fl}) float32 -> ({n_fl}, {wk}) words",
            lambda: pack_kernel.binarize_pack_cuda(x500),
            lambda: pack_kernel.binarize_pack_plain(x500), None,
            bound(4 * n_fl * f_fl + 4 * n_fl * wk, [(n_fl * f_fl, FP32_OPS_PER_S)])),
        "bmm_xnor": (
            f"A ({n_fl}, {wk}) x B ({HIDDEN}, {wk}) words, K={f_fl} -> "
            f"({n_fl}, {HIDDEN}) int32",
            lambda: bmm_kernel.bmm_xnor_cuda(a_w, b_w, f_fl),
            lambda: bmm_kernel.bmm_xnor_plain(a_w, b_w, f_fl),
            lambda: torch.matmul(a_pm1, b_pm1),
            bound(4 * (n_fl + HIDDEN) * wk + 4 * n_fl * HIDDEN,
                  [(2 * n_fl * HIDDEN * f_fl, INT8_TC_OPS_PER_S)])),
        "bspmm_bits": (
            f"flickr 0/1 FRDC ({adj_b.n_groups} groups, {adj_b.nnz} edges) x "
            f"({n_fl}, 2) words -> ({r4}, {HIDDEN}) int32 counts, s3",
            lambda: bspmm_kernel.bspmm_bits_cuda(adj_b, h_w, HIDDEN, False),
            lambda: bspmm_kernel.bspmm_bits_plain(adj_b, h_w, HIDDEN, False),
            bits_lib,
            bound(group_bytes(adj_b) + 4 * h_w.numel() + 4 * r4 * HIDDEN,
                  [(2 * adj_b.nnz * HIDDEN, INT8_TC_OPS_PER_S)])),
        "bspmm_fp": (
            f"flickr GCN FRDC ({adj_g.n_groups} groups, {adj_g.nnz} edges) x "
            f"({n_fl}, {HIDDEN}) float32 -> ({r4}, {HIDDEN}), raw",
            lambda: bspmm_kernel.bspmm_fp_cuda(adj_g, h_fp),
            lambda: bspmm_kernel.bspmm_fp_plain(adj_g, h_fp),
            lambda: torch.sparse.mm(csr, h_fp),
            bound(group_bytes(adj_g) + 4 * n_fl * HIDDEN + 4 * r4 * HIDDEN,
                  [(2 * adj_g.nnz * HIDDEN, FP32_OPS_PER_S)])),
    }
    records = []
    for name, (shape, kern, plain, lib, b) in specs.items():
        records.append(kernel_record(
            name, shape, launches[name], err[name], cuda_ms(torch, kern),
            cuda_ms(torch, plain, iters=5, warmup=1),
            cuda_ms(torch, lib) if lib is not None else None, b))
    # the high-degree case of the reddit run, printed beside the record
    adj_r = adjs["reddit"]["binary"]
    h_r = rand_words(n_rd, HIDDEN)
    r_bound = bound(group_bytes(adj_r) + 4 * h_r.numel()
                    + 4 * adj_r.n_tile_rows * 4 * HIDDEN,
                    [(2 * adj_r.nnz * HIDDEN, INT8_TC_OPS_PER_S)])[0]
    r_call = lambda: bspmm_kernel.bspmm_bits_cuda(adj_r, h_r, HIDDEN, False)  # noqa: E731
    r_lib = bits_yardstick(torch, bitops, adj_r, h_r, HIDDEN, r_call())
    log(f"time bspmm_bits reddit-0.1 [{adj_r.n_groups} groups, {adj_r.nnz} "
        f"edges]: kernel {cuda_ms(torch, r_call):.4f} ms, bound {r_bound:.4f} "
        f"ms, library {cuda_ms(torch, r_lib):.4f} ms (torch.sparse.mm)")
    # bspmm_fp at every layer 2's width (F = 7), beside its own yardstick
    n_cls = flickr.n_classes
    h7 = card(rng.standard_normal((n_fl, n_cls)).astype(np.float32))
    f7_bound = bound(group_bytes(adj_g) + 4 * n_fl * n_cls + 4 * r4 * n_cls,
                     [(2 * adj_g.nnz * n_cls, FP32_OPS_PER_S)])
    f7 = {"kernel": cuda_ms(torch, lambda: bspmm_kernel.bspmm_fp_cuda(adj_g, h7)),
          "plain": cuda_ms(torch, lambda: bspmm_kernel.bspmm_fp_plain(adj_g, h7),
                           iters=5, warmup=1),
          "torch.sparse.mm": cuda_ms(torch, lambda: torch.sparse.mm(csr, h7))}
    log(f"time bspmm_fp F={n_cls} [flickr GCN FRDC ({adj_g.n_groups} groups, "
        f"{adj_g.nnz} edges) x ({n_fl}, {n_cls}) float32 -> ({r4}, {n_cls}), "
        f"raw]: kernel {f7['kernel']:.4f} ms, plain {f7['plain']:.4f} ms, "
        f"bound {f7_bound[0]:.4f} ms ({f7_bound[1]}), library "
        f"{f7['torch.sparse.mm']:.4f} ms (torch.sparse.mm)")
    log("device ms (torch.profiler): " + json.dumps({
        f"bspmm_bits F={HIDDEN}": device_ms(
            torch, lambda: bspmm_kernel.bspmm_bits_cuda(adj_b, h_w, HIDDEN, False)),
        f"torch.sparse.mm bits F={HIDDEN}": device_ms(torch, bits_lib),
        f"bspmm_bits reddit-0.1 F={HIDDEN}": device_ms(torch, r_call),
        f"torch.sparse.mm reddit-0.1 F={HIDDEN}": device_ms(torch, r_lib),
        f"bspmm_fp F={HIDDEN}": device_ms(
            torch, lambda: bspmm_kernel.bspmm_fp_cuda(adj_g, h_fp)),
        f"torch.sparse.mm F={HIDDEN}": device_ms(
            torch, lambda: torch.sparse.mm(csr, h_fp)),
        f"bspmm_fp F={n_cls}": device_ms(
            torch, lambda: bspmm_kernel.bspmm_fp_cuda(adj_g, h7)),
        f"torch.sparse.mm F={n_cls}": device_ms(
            torch, lambda: torch.sparse.mm(csr, h7))}))
    # bmm_xnor at each distinct shape the forwards give it, beside a bf16
    # matmul of the unpacked +-1 operands (tools/xform_variants.py times the
    # route not taken)
    bmm_shapes = sorted({(n_fl, HIDDEN, f_fl), (n_fl, n_cls, HIDDEN),
                         (n_fl, HIDDEN, HIDDEN), (n_rd, reddit.n_classes, HIDDEN)})
    bmm_times, bmm_attrs = {}, {}
    for m, n, k in bmm_shapes:
        a, b = rand_words(m, k), rand_words(n, k)
        a16 = (2 * card(rng.integers(0, 2, (m, k))) - 1).to(torch.bfloat16)
        b16 = (2 * card(rng.integers(0, 2, (k, n))) - 1).to(torch.bfloat16)
        wk_k = bitops.padded_words(k)
        b_ms, b_by = bound(4 * (m + n) * wk_k + 4 * m * n,
                           [(2 * m * n * k, INT8_TC_OPS_PER_S)])
        row = {"bound_ms": b_ms, "bound_by": b_by}
        for key, fn in (("bmm_xnor", lambda: bmm_kernel.bmm_xnor_cuda(a, b, k)),
                        ("bf16 torch.matmul", lambda: a16 @ b16)):
            row[key] = {"ms": cuda_ms(torch, fn),
                        "device_ms": device_ms(torch, fn)}
        bmm_attrs[f"N={n} Wk={wk_k}"] = bmm_kernel.attributes(n, wk_k)
        bmm_times[f"{m}x{n}x{k}"] = row
    log("time bmm_xnor per main-path shape (M x N x K; simt route at N <= 8, "
        "mma above): " + json.dumps(bmm_times))
    log("kernel attributes bmm_xnor: " + json.dumps(bmm_attrs))
    log_attributes(torch, build, bspmm_kernel, {
        "bspmm_fp F=64": ("bspmm", "bspmm_fp", h_fp, HIDDEN),
        f"bspmm_fp F={n_cls}": ("bspmm", "bspmm_fp", h7, n_cls)})
    log("kernel attributes bspmm_bits (words a row, s2): " + json.dumps({
        f"{w}, {s2}": build.attributes("bspmm", "bspmm_bits", w, s2)
        for w in (1, 2, 4) for s2 in (0, 1)}))
    log("forward ms: " + json.dumps(forward_ms))
    log(f"phases 1-4: {time.perf_counter() - t_start:.1f} s")
    serve_records, single, params, stores = run_serve(torch, flickr)
    records += serve_records
    sharded_records, sharded_store = run_sharded(torch, flickr, single,
                                                 params)
    records += sharded_records
    # the engine paths' launches join each kernel's count
    engine_launches = run_engine(torch, flickr, stores, sharded_store, single)
    for rec in records:
        rec["launches"] += engine_launches.get(rec["name"], 0)
    return {"kernels": records}


def log_attributes(torch, build, bspmm_kernel, cases) -> None:
    """Registers a thread, static shared memory and resident blocks per SM
    of the fp kernels in the lane layout each case's x gets (``cases``:
    label -> (library, function, x, pass width))."""
    out = {}
    for label, (lib, fn, x, width) in cases.items():
        lay = bspmm_kernel.fp_layout(width, x.shape[1], x.data_ptr())
        out[label] = {"layout": list(lay), **build.attributes(
            lib, fn, lay.sub, lay.cols, int(lay.vec))}
    log("kernel attributes: " + json.dumps(out))


class transform_only:
    """While active, every fused layer launch runs with ``aggregate = 0``,
    so the kernel returns after its transform phase: the wrapper builds its
    parameters as always, and only the flag in the struct it passes
    changes. Without aggregation the transform writes its products (the
    self branch's too) without the column scale."""

    def __init__(self, build):
        self.lib = build.library("fused_layer")

    def __enter__(self):
        self.real = self.lib.fused_layer

        def launch(params, stream):
            params._obj.aggregate = 0
            return self.real(params, stream)
        self.lib.fused_layer = launch

    def __exit__(self, *exc):
        self.lib.fused_layer = self.real


def fused_kinds(torch, fused_layer, bitops, card, rng, d) -> None:
    """Each fused kind at the serve bucket, whole and transform-only, beside
    its yardstick (one PyTorch call of the transform's product) and the
    bounds of both, on CUDA events (tools/xform_step0.py takes the device
    times: after the serve phase torch.profiler under-counts here); then
    the kernel's registers and occupancy at each kind's dynamic shared
    memory."""
    import numpy as np
    from repro_torch.kernels import build
    x_pad, h_pad, bn, q = d["x_pad"], d["h_pad"], d["bn"], d["q"]
    bin_b, adj_b, items, nnz = d["bin_b"], d["adj_b"], d["items"], d["nnz"]
    n, f = x_pad.shape
    h, c = HIDDEN, d["w2"].packed.shape[0]
    wh, wk_f, wk_h = -(-h // 32), bitops.padded_words(f), bitops.padded_words(h)
    x_h = card(rng.standard_normal((n, h)).astype(np.float32))
    bn_h = (card(0.1 * rng.standard_normal((1, h)).astype(np.float32)),
            card(rng.uniform(0.5, 2.0, (1, h)).astype(np.float32)))
    z = fused_layer._bn(x_pad, bn[0])
    w_eff = (bitops.unpack_pm1(q.w1.packed, q.w1.n) * q.w1.scale).T.contiguous()

    def pm1(r, k):
        return (2 * card(rng.integers(0, 2, (r, k))) - 1).to(torch.bfloat16)
    a_f, a_h, b_f2h, b_hc = pm1(n, f), pm1(n, h), pm1(f, 2 * h), pm1(h, c)
    agg_bytes = {
        "bin": group_bytes(bin_b) + 4 * (bin_b.n_tile_rows + 1),
        "adj": group_bytes(adj_b) + 4 * (adj_b.n_tile_rows + 1) + 8 * n}
    fl = fused_layer
    # name: (call, attributes' (f, fbb, self_branch), (yardstick, call),
    # input bytes, transform output bytes, final output bytes, adjacency,
    # transform ops, aggregation ops)
    kinds = {
        "gcn_bin_l1 (500 -> 64)": (
            lambda: fl.gcn_bin_l1(x_pad, bn[0], q.w1, bin_b, item_ptr=items["bin"]),
            (f, True, False),
            ("fp32 torch.matmul(z, w_eff)", lambda: z @ w_eff),
            4 * n * f + 8 * f + 4 * h * (wk_f + 1), 4 * n * wh, 4 * n * wh, "bin",
            [(2 * n * f * h, FP32_OPS_PER_S)],
            [(2 * nnz["bin"] * h, INT8_TC_OPS_PER_S)]),
        "gcn_bbf_fbf (words 64 -> 7)": (
            lambda: fl.gcn_bbf_fbf(h_pad, None, q.w2, adj_b, item_ptr=items["adj"]),
            (h, False, False),
            ("bf16 torch.matmul", lambda: a_h @ b_hc),
            4 * n * wh + 4 * c * (wh + 1), 4 * n * c, 4 * n * c, "adj",
            [(2 * n * c * h, INT8_TC_OPS_PER_S)],
            [(2 * nnz["adj"] * c, FP32_OPS_PER_S)]),
        "branch_add (500 -> 64)": (
            lambda: fl.branch_add(x_pad, bn[0], d["w1"], d["w1b"], adj_b,
                                  item_ptr=items["adj"]),
            (f, False, True),
            ("bf16 torch.matmul, both weights", lambda: a_f @ b_f2h),
            4 * n * f + 8 * f + 8 * h * (wk_f + 1), 8 * n * h, 4 * n * h, "adj",
            [(4 * n * h * f, INT8_TC_OPS_PER_S), (2 * n * f, FP32_OPS_PER_S)],
            [(2 * nnz["adj"] * h, FP32_OPS_PER_S)]),
        "fc (64 -> 7)": (
            lambda: fl.fc(x_h, bn_h, d["w2"]),
            (h, False, False),
            ("bf16 torch.matmul", lambda: a_h @ b_hc),
            4 * n * h + 8 * h + 4 * c * (wk_h + 1), 4 * n * c, 4 * n * c, None,
            [(2 * n * c * h, INT8_TC_OPS_PER_S), (2 * n * h, FP32_OPS_PER_S)],
            []),
    }
    out, attrs = {}, {}
    for name, (call, layer, (yname, yard), b_in, b_y, b_out, adj, ops_t,
               ops_a) in kinds.items():
        row = {"whole_ms": cuda_ms(torch, call)}
        with transform_only(build):
            row["transform_ms"] = cuda_ms(torch, call)
        row["whole_bound_ms"], row["whole_bound_by"] = bound(
            b_in + b_out + (agg_bytes[adj] if adj else 0), ops_t + ops_a)
        row["transform_bound_ms"], row["transform_bound_by"] = bound(
            b_in + b_y, ops_t)
        row["yardstick"] = yname
        row["yardstick_ms"] = cuda_ms(torch, yard)
        out[name] = row
        attrs[name] = fl.attributes(*layer)
    log("time fused_layer per kind at the bucket: " + json.dumps(out))
    log("kernel attributes fused_layer: " + json.dumps(attrs))

# why a kernel has no library yardstick (library_ms null)
NO_LIBRARY = {
    "binarize_pack": "no PyTorch call packs sign bits into words",
    "fused_layer": "no single PyTorch call computes a whole layer "
                   "(BN, binary transform, aggregation)",
}
NO_LIBRARY.update({f"fused_layer/{k}": NO_LIBRARY["fused_layer"]
                   for k in PAIR_KINDS})


def kernel_record(name, shape, launches, max_err, ms, plain_ms, lib_ms,
                  bound_pair) -> dict:
    b_ms, b_by = bound_pair
    source, replaces = REPLACES[name]
    lib = f"{lib_ms:.4f} ms" if lib_ms is not None \
        else f"null ({NO_LIBRARY[name]})"
    log(f"time {name} [{shape}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}), library {lib}")
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def run_serve(torch, flickr) -> tuple:
    """Phases 5-7: the serving slice on full Flickr. Returns the kernel
    records of the 2D-grid and fused kernels, the single-host GCN "bin"
    session of way (a), the models' parameters and the GCN stores of the
    three ways."""
    import tempfile
    from functools import partial

    import numpy as np
    from repro_torch.core import bitops, frdc
    from repro_torch.core.binarize import BinTensor
    from repro_torch.core.bmm import bmm, quantize_act
    from repro_torch.graphs import sampling
    from repro_torch.kernels import bspmm_kernel, build, fused_layer, ops
    from repro_torch.models import gnn
    from repro_torch.serve import GraphStore, session_core
    from repro_torch.serve.gnn_session import CompiledGraphSession

    dev = DEVICE
    rng = np.random.default_rng(SEED + 1)
    err = {k: 0.0 for k in SERVE_KERNELS}
    n_fl, f_fl = flickr.x.shape
    n_cls = flickr.n_classes
    t_start = time.perf_counter()

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def words(rows, nbits):
        return bitops.pack_bits(card(rng.integers(0, 2, (rows, nbits))))

    def hold(kernel, got, want, n_bits=None, magnitude=None):
        hold_to(torch, err, kernel, got, want, n_bits, magnitude)

    # -- sessions: GCN "bin" three ways, SAGE and SAINT fused ---------------
    params = {fam: getattr(gnn, f"init_{fam}")(SEED, f_fl, HIDDEN, n_cls, dev)
              for fam in ("gcn", "sage", "saint")}
    ways = {"a": {}, "b": dict(bspmm_block=GRID_BLOCK), "c": dict(fused=True)}

    def store(fam, **kw):
        st = GraphStore(max_batch=SERVE_BATCH, khop=2, use_pallas=True,
                        device=dev, **kw)
        st.register_graph("flickr", flickr)
        st.register_model(fam, fam, params[fam])
        return st

    t0 = time.perf_counter()
    stores = {w: store("gcn", **kw) for w, kw in ways.items()}
    sessions = {w: st.session("flickr", "gcn") for w, st in stores.items()}
    for fam in ("sage", "saint"):
        sessions[fam] = store(fam, fused=True).session("flickr", fam)
    compiles = {}
    for name, sess in sessions.items():
        sess.warmup(np.random.default_rng(SEED), probes=WARMUP_PROBES)
        compiles[name] = sess.compile_count
    torch.cuda.synchronize()
    log(f"serve sessions + warmup: {time.perf_counter() - t0:.1f} s; plans "
        + json.dumps({k: v.plan.name() for k, v in sessions.items()})
        + "; programs " + json.dumps(compiles))

    seeds = np.random.default_rng(SEED + 2).integers(
        0, n_fl, size=(SERVE_BATCHES, SERVE_BATCH))
    # the serve bucket of the first batch, as ServeCore stages it
    staged = sessions["c"].prepare_batch(seeds[0]).groups[0].staged
    n_pad = staged.x_pad.shape[0]
    nnz = {k: int(np.unpackbits(a["tiles"].numpy().astype(np.uint16)
                                .view(np.uint8)).sum())
           for k, a in staged.adjs.items()}
    bucket = {k: session_core.frdc_rebuild(
        {f: v.to(dev) for f, v in a.items() if f != "item_ptr"}, n_pad, n_pad,
        nnz[k]) for k, a in staged.adjs.items()}
    bin_b, adj_b = bucket["bin"], bucket["adj"]
    log(f"serve bucket: {n_pad} rows, groups (real, padded) "
        + json.dumps({k: (real_groups(m), m.n_groups)
                      for k, m in bucket.items()})
        + ", edges " + json.dumps(nnz))

    # -- 5. parity of the grid and fused kernels -----------------------------
    t0 = time.perf_counter()
    small = (rng.random((40, 40)) < 0.2).astype(np.float32)
    small[20:] = 0
    edge_adjs = [frdc.from_dense(np.ones((3, 3), np.float32), device=dev),
                 frdc.from_dense(small, device=dev)]
    edge_adjs.append(frdc.pad_frdc(edge_adjs[1], 64,
                                   n_groups=edge_adjs[1].n_groups + 7))
    full_bin = flickr.adjacency("binary", dev)       # the 1,399-group row
    full_gcn = flickr.adjacency("gcn", dev)
    cases = 0
    bits_cases = [(bin_b, HIDDEN, blk) for blk in (GRID_BLOCK, (4, None),
                                                     (8, 64))]
    bits_cases += [(full_bin, HIDDEN, GRID_BLOCK)]
    bits_cases += [(a, f, blk) for a in edge_adjs for f in (7, 100)
                   for blk in ((4, None), (8, 32), (32, f))]
    for adj, f, blk in bits_cases:
        plan = bspmm_kernel._block_plan(blk, f, True)
        x = words(adj.n_cols, f)
        for binz in (False, True):
            for mode in ("s3_two_popc", "s2_and_andnot"):
                got = bspmm_kernel.bspmm_bits_grid_cuda(adj, x, f, binz, mode,
                                                        plan)
                hold("bspmm_bits_grid", got, bspmm_kernel.bspmm_bits_grid_plain(
                    adj, x, f, binz, mode, plan), n_bits=f if binz else None)
                hold("bspmm_bits_grid", got, bspmm_kernel.bspmm_bits_grid_cuda(
                    adj, x, f, binz, mode, plan))          # deterministic
                cases += 1
    fp_cases = [(adj_b, f, GRID_BLOCK) for f in (n_cls, HIDDEN)]
    fp_cases += [(full_gcn, HIDDEN, GRID_BLOCK), (full_bin, n_cls, (16, None))]
    fp_cases += [(a, f, blk) for a in edge_adjs for f in (7, 100)
                 for blk in ((4, None), (8, 24), (32, 32))]
    for adj, f, blk in fp_cases:
        plan = bspmm_kernel._block_plan(blk, f, False)
        x = card(rng.standard_normal((adj.n_cols, f)).astype(np.float32))
        got = bspmm_kernel.bspmm_fp_grid_cuda(adj, x, plan)
        hold("bspmm_fp_grid", got, bspmm_kernel.bspmm_fp_grid_plain(adj, x, plan),
             magnitude=bspmm_kernel.bspmm_fp_grid_plain(adj, x.abs(), plan))
        hold("bspmm_fp_grid", got, bspmm_kernel.bspmm_fp_grid_cuda(adj, x, plan))
        cases += 1

    # fused kinds at the bucket shapes, on inputs whose transform sums are
    # exact in any order (integer features, BN by integers, +-1 weights
    # with power-of-two scales): packed words bit-exact, fp outputs within
    # FP_TOL of their sum of |terms|; against the plain version on the card
    # and the unfused layer composition on the CPU
    def ints(shape, lo, hi):
        return card(rng.integers(lo, hi, shape).astype(np.float32))

    def weights(n_out, n_in):
        return BinTensor(words(n_out, n_in), card(rng.choice(
            [0.25, 0.5, 1.0], (n_out, 1)).astype(np.float32)), n_in)

    x_i, x_h = ints((n_pad, f_fl), -3, 4), ints((n_pad, HIDDEN), -3, 4)
    bn_i = (ints((1, f_fl), -1, 2), card(rng.choice([1.0, 2.0], (1, f_fl))
                                        .astype(np.float32)))
    bn_h = (ints((1, HIDDEN), -1, 2), card(rng.choice([1.0, 2.0], (1, HIDDEN))
                                          .astype(np.float32)))
    w1, w1b, w2 = weights(HIDDEN, f_fl), weights(HIDDEN, f_fl), \
        weights(n_cls, HIDDEN)
    h_w = words(n_pad, HIDDEN)
    ones = torch.ones((n_pad, 1), device=dev)

    def cpu(t):
        if t is None:
            return None
        if isinstance(t, BinTensor):
            return BinTensor(t.packed.cpu(), t.scale.cpu(), t.n)
        if isinstance(t, frdc.FRDCMatrix):
            return t.to("cpu")
        if isinstance(t, tuple):
            return tuple(cpu(v) for v in t)
        return t.to("cpu")

    fl = fused_layer
    kinds = {   # name: (fused call, args, unfused layer on CPU args, mag)
        "gcn_bin_l1": (fl.gcn_bin_l1, (x_i, bn_i, w1, bin_b),
                       lambda x, bn, w, a: gnn.gcn_bitgnn_layers(
                           gnn.GCNQuant(w, w2), "bin")[0](
                           gnn._BNTap((bn,)), x, {"bin": a}).packed),
        "gcn_bbf_fbf/words": (fl.gcn_bbf_fbf, (h_w, None, w2, adj_b),
                              lambda h, bn, w, a: gnn.gcn_bitgnn_layers(
                                  gnn.GCNQuant(w1, w), "bin")[1](
                                  None, BinTensor(h, ones.cpu(), HIDDEN),
                                  {"adj": a})),
        "gcn_bbf_fbf/relu": (lambda *a: fl.gcn_bbf_fbf(*a, relu=True),
                             (x_i, bn_i, w1, adj_b),
                             lambda x, bn, w, a: gnn.gcn_bitgnn_layers(
                                 gnn.GCNQuant(w, w2), "full")[0](
                                 gnn._BNTap((bn,)), x, {"adj": a})),
        "branch_add": (lambda *a: fl.branch_add(*a, relu=True),
                       (x_i, bn_i, w1, w1b, adj_b),
                       lambda x, bn, ws, wa, a: gnn._branch_add_layer(
                           ws, wa, True)(gnn._BNTap((bn,)), x, {"adj": a})),
        "fc": (fl.fc, (x_h, bn_h, w2),
               lambda x, bn, w: bmm(quantize_act(gnn._BNTap((bn,))(x)), w,
                                    "BBF")),
    }
    for kind, (call, args, unfused, ) in kinds.items():
        got = call(*args)
        hold("fused_layer", got, call(*args))                 # deterministic
        base = kind.split("/")[0]
        want = getattr(fl, f"{base}_plain")(*args, **(
            {"relu": True} if kind in ("gcn_bbf_fbf/relu", "branch_add")
            else {}))
        want_cpu = unfused(*(cpu(a) for a in args))
        if got.dtype == torch.int32:
            n = w1.packed.shape[0]
            hold("fused_layer", got, want, n_bits=n)
            hold("fused_layer", got, want_cpu, n_bits=n)
        else:
            words_in, xs = fl._input(args[0], args[1])
            w_agg = args[3] if kind == "branch_add" else args[2]
            mag = torch.zeros((), device=dev)
            if kind != "fc":
                mag = fl.agg_fp(args[-1], fl._bbf(words_in, xs, w_agg).abs())
            if kind == "branch_add":
                mag = mag + fl._bbf(words_in, xs, args[2]).abs()
            hold("fused_layer", got, want, magnitude=mag)
            hold("fused_layer", got, want_cpu, magnitude=mag)
        cases += 1
    torch.cuda.synchronize()
    log(f"parity (serve kernels): {cases} cases passed in "
        f"{time.perf_counter() - t0:.1f} s; max abs err " + json.dumps(err))

    # -- 6. the serving path: 8 batches of 32 seeds per GCN way, 2 for SAGE
    # and SAINT, each held against the full-graph forward and the CPU ------
    t0 = time.perf_counter()
    n_layers = {"a": 2, "b": 2, "c": 2, "sage": 2, "saint": 3}
    launches = {k: 0 for k in SERVE_KERNELS}
    served, serve_ms, serve_split = {}, {}, {}
    for name, sess in sessions.items():
        n_b = SERVE_BATCHES if name in ways else 2
        ops.reset_launch_counts()
        outs, times = [], []
        for i in range(n_b):
            t1 = time.perf_counter()
            outs.append(sess.serve_subgraph(seeds[i]))
            times.append((time.perf_counter() - t1) * 1e3)
        counts = ops.launch_counts()
        for k in SERVE_KERNELS:
            launches[k] += counts[k]
        if sess.compile_count != compiles[name]:
            raise AssertionError(f"serve {name}: {sess.compile_count - compiles[name]} "
                                 f"new programs after warmup")
        grid = counts["bspmm_bits_grid"] + counts["bspmm_fp_grid"]
        one_d = counts["bspmm_bits"] + counts["bspmm_fp"]
        if name == "a" and (grid or counts["fused_layer"] or not one_d):
            raise AssertionError(f"serve a launched {counts}")
        if name == "b" and (one_d or counts["fused_layer"]
                            or not counts["bspmm_bits_grid"]
                            or not counts["bspmm_fp_grid"]):
            raise AssertionError(f"serve b launched {counts}")
        if name not in ("a", "b"):
            others = {k: v for k, v in counts.items()
                      if k != "fused_layer" and v}
            if counts["fused_layer"] != n_layers[name] * n_b or others:
                raise AssertionError(f"serve {name}: {counts}, want "
                                     f"{n_layers[name] * n_b} fused only")
        served[name] = np.concatenate(outs)
        serve_ms[name] = (float(np.percentile(times, 50)),
                          float(np.percentile(times, 90)))
        # where a batch's time goes: the extract stage (host) against
        # launch + finish (copies to the card, kernels, copy back)
        split = []
        for i in range(2):
            t1 = time.perf_counter()
            prep = sess.prepare_batch(seeds[i])
            t2 = time.perf_counter()
            sess.finish_batch(prep, sess.launch_batch(prep))
            split.append(((t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3))
        serve_split[name] = tuple(float(np.median(v)) for v in zip(*split))
        log(f"serve {name}: launches {json.dumps(counts)}; per batch p50 "
            f"{serve_ms[name][0]:.3f} ms, p90 {serve_ms[name][1]:.3f} ms; "
            f"extract {serve_split[name][0]:.3f} ms, launch + finish "
            f"{serve_split[name][1]:.3f} ms")

    for name, sess in sessions.items():
        n_b = SERVE_BATCHES if name in ways else 2
        flat = seeds[:n_b].reshape(-1)
        agree(f"{name} vs the card's full-graph forward", served[name],
              sess.full_logits()[flat])
        twin = CompiledGraphSession(
            sess.graph, sess.model, sess.plan,
            type(sess.qparams)(*(cpu(w) for w in sess.qparams)),
            khop=sess.khop, max_batch=sess.max_batch,
            adj_full={k: m.to("cpu") for k, m in sess._adj_full.items()},
            use_pallas=True, device="cpu")
        twin.bn = cpu(sess.bn)                # the card's frozen BN
        twin.feature_version = sess.feature_version
        agree(f"{name} vs the CPU", served[name], np.concatenate(
            [twin.serve_subgraph(seeds[i]) for i in range(n_b)]))
    agree("b vs a", served["b"], served["a"])
    agree("c vs a", served["c"], served["a"])

    # the fused kernel over the whole graph: the frozen full forward of (c)
    sess_c = sessions["c"]
    ops.reset_launch_counts()
    fused_full = sess_c.full_forward(sess_c._x_dev, sess_c.bn)
    torch.cuda.synchronize()
    if ops.launch_counts()["fused_layer"] != 2:
        raise AssertionError("full-graph fused forward: "
                             + json.dumps(ops.launch_counts()))
    agree("c full graph fused vs unfused", fused_full.cpu().numpy(),
          sess_c.full_logits())

    # artifact round trip: (a) saved, restored into a new store
    with tempfile.TemporaryDirectory() as tmp:
        sessions["a"].save(Path(tmp) / "flickr__gcn")
        st2 = store("gcn", cache_dir=tmp)
        if CompiledGraphSession.load(
                Path(tmp) / "flickr__gcn", st2.graphs["flickr"],
                st2.models["gcn"], khop=2, max_batch=SERVE_BATCH,
                use_pallas=True, bspmm_block=None, fused=False,
                device=dev) is None:
            raise AssertionError("artifact of (a) did not restore")
        restored = st2.session("flickr", "gcn")
        agree("restored artifact vs a", np.concatenate(
            [restored.serve_subgraph(seeds[i]) for i in range(2)]),
            served["a"][:2 * SERVE_BATCH])
    log(f"serve checks: {time.perf_counter() - t0:.1f} s")

    # -- 7. times ------------------------------------------------------------
    x_pad = card(staged.x_pad)
    sess_a = sessions["a"]
    h_pad = words(n_pad, HIDDEN)
    y_pad = card(rng.standard_normal((n_pad, n_cls)).astype(np.float32))
    grid_bits = bspmm_kernel._block_plan(GRID_BLOCK, HIDDEN, True)
    grid_fp = bspmm_kernel._block_plan(GRID_BLOCK, n_cls, False)
    uniq = np.unique(seeds[0])
    ex = sampling.extract_khop(sess_a.graph.csr, uniq, 2)
    loops = np.arange(ex.sub_nodes.size)
    rows = np.concatenate([ex.sub_edges[0], loops])
    cols = np.concatenate([ex.sub_edges[1], loops])
    csr = torch.sparse_coo_tensor(card(np.stack([rows, cols])),
                                  torch.ones(rows.size, device=dev),
                                  (n_pad, n_pad)).coalesce().to_sparse_csr()
    q, bn = sess_c.qparams, sess_c.bn
    items = {k: a["item_ptr"].to(dev) for k, a in staged.adjs.items()}

    def fused_fwd():
        h = fused_layer.gcn_bin_l1(x_pad, bn[0], q.w1, bin_b,
                                   item_ptr=items["bin"])
        return fused_layer.gcn_bbf_fbf(h, None, q.w2, adj_b,
                                       item_ptr=items["adj"])

    def fused_plain():
        h = fused_layer.gcn_bin_l1_plain(x_pad, bn[0], q.w1, bin_b)
        return fused_layer.gcn_bbf_fbf_plain(h, None, q.w2, adj_b)

    wh = -(-HIDDEN // 32)
    grid_call = lambda: bspmm_kernel.bspmm_bits_grid_cuda(  # noqa: E731
        bin_b, h_pad, HIDDEN, False, plan=grid_bits)
    grid_lib = bits_yardstick(torch, bitops, bin_b, h_pad, HIDDEN, grid_call())
    full_bits = bspmm_kernel._block_plan((GRID_BLOCK[0], None), HIDDEN, True)
    fused_bytes = (4 * n_pad * f_fl + 8 * f_fl + 4 * HIDDEN * (q.w1.packed.shape[1] + 1)
                   + group_bytes(bin_b) + 4 * (bin_b.n_tile_rows + 1)
                   + 4 * n_pad * wh                            # layer 1 out
                   + 4 * n_pad * wh + 4 * n_cls * (wh + 1)     # layer 2 in
                   + group_bytes(adj_b) + 4 * (adj_b.n_tile_rows + 1)
                   + 8 * n_pad + 4 * n_pad * n_cls)
    specs = {
        "bspmm_bits_grid": (
            f"serve bucket 0/1 FRDC ({real_groups(bin_b)} groups of "
            f"{bin_b.n_groups} padded, {nnz['bin']} edges) x ({n_pad}, {wh}) "
            f"words -> ({n_pad}, {HIDDEN}) int32 counts, block {GRID_BLOCK}",
            lambda: bspmm_kernel.bspmm_bits_grid_cuda(bin_b, h_pad, HIDDEN,
                                                      False, plan=grid_bits),
            lambda: bspmm_kernel.bspmm_bits_grid_plain(bin_b, h_pad, HIDDEN,
                                                       False, plan=grid_bits),
            grid_lib,
            bound(group_bytes(bin_b) + 4 * h_pad.numel() + 4 * n_pad * HIDDEN,
                  [(2 * nnz["bin"] * HIDDEN, INT8_TC_OPS_PER_S)])),
        "bspmm_fp_grid": (
            f"serve bucket GCN FRDC ({real_groups(adj_b)} groups of "
            f"{adj_b.n_groups} padded, {nnz['adj']} edges) x ({n_pad}, "
            f"{n_cls}) float32 -> ({n_pad}, {n_cls}), raw, block {GRID_BLOCK}",
            lambda: bspmm_kernel.bspmm_fp_grid_cuda(adj_b, y_pad, grid_fp),
            lambda: bspmm_kernel.bspmm_fp_grid_plain(adj_b, y_pad, grid_fp),
            lambda: torch.sparse.mm(csr, y_pad),
            bound(group_bytes(adj_b) + 4 * y_pad.numel() + 4 * n_pad * n_cls,
                  [(2 * nnz["adj"] * n_cls, FP32_OPS_PER_S)])),
        "fused_layer": (
            f"one GCN bin serve forward on the bucket, 2 launches: "
            f"gcn_bin_l1 ({n_pad}, {f_fl}) -> ({n_pad}, {wh}) words, "
            f"gcn_bbf_fbf -> ({n_pad}, {n_cls})",
            fused_fwd, fused_plain, None,
            bound(fused_bytes,
                  [(2 * n_pad * f_fl * (HIDDEN + 1), FP32_OPS_PER_S),
                   (2 * nnz["bin"] * HIDDEN + 2 * n_pad * HIDDEN * n_cls,
                    INT8_TC_OPS_PER_S),
                   (2 * nnz["adj"] * n_cls, FP32_OPS_PER_S)])),
    }
    records = []
    for name, (shape, kern, plain, lib, b) in specs.items():
        records.append(kernel_record(
            name, shape, launches[name], err[name], cuda_ms(torch, kern),
            cuda_ms(torch, plain, iters=5, warmup=1),
            cuda_ms(torch, lib) if lib is not None else None, b))
    fused_kinds(torch, fused_layer, bitops, card, rng, dict(
        x_pad=x_pad, h_pad=h_pad, bn=bn, q=q, w1=w1, w1b=w1b, w2=w2,
        bin_b=bin_b, adj_b=adj_b, items=items, nnz=nnz))
    log("device ms (torch.profiler): " + json.dumps({
        f"bspmm_bits_grid block {GRID_BLOCK}": device_ms(torch, grid_call),
        f"bspmm_bits_grid block {(GRID_BLOCK[0], None)}": device_ms(
            torch, lambda: bspmm_kernel.bspmm_bits_grid_cuda(
                bin_b, h_pad, HIDDEN, False, plan=full_bits)),
        "torch.sparse.mm bits": device_ms(torch, grid_lib),
        "bspmm_fp_grid": device_ms(torch, lambda: bspmm_kernel.bspmm_fp_grid_cuda(
            adj_b, y_pad, grid_fp)),
        "torch.sparse.mm": device_ms(torch, lambda: torch.sparse.mm(csr, y_pad))}))
    log("kernel attributes bspmm_bits_grid (words a block, s2): " + json.dumps({
        f"{w}, {s2}": build.attributes("bspmm_grid", "bspmm_bits_grid", w, s2)
        for w in (1, 2) for s2 in (0, 1)}))
    log_attributes(torch, build, bspmm_kernel, {
        f"bspmm_fp_grid F={n_cls} block {GRID_BLOCK}": (
            "bspmm_grid", "bspmm_fp_grid", y_pad,
            bspmm_kernel._grid_geometry(adj_b, grid_fp, n_cls)[2])})
    full_ms = {w: host_ms(torch, lambda s=sessions[w]: s.full_forward(s._x_dev))
               for w in ("a", "b")}
    full_ms["c frozen, fused"] = host_ms(
        torch, lambda: sess_c.full_forward(sess_c._x_dev, sess_c.bn))
    full_ms["a frozen"] = host_ms(
        torch, lambda: sess_a.full_forward(sess_a._x_dev, sess_a.bn))
    log("serve per-batch ms (p50, p90): " + json.dumps(serve_ms))
    log("serve per-batch split ms (extract, launch + finish): "
        + json.dumps(serve_split))
    log("full-graph forward ms (full_logits refresh): " + json.dumps(full_ms))
    log(f"phases 5-7: {time.perf_counter() - t_start:.1f} s")
    return records, sess_a, params, stores


def sharded_plan(session_core, family, scheme, fused):
    variants = (session_core.GCN_SCHEME_VARIANTS[scheme] if family == "gcn"
                else session_core.FIXED_VARIANTS)
    return session_core.SessionPlan(family, scheme, layer_variants=variants,
                                    fused=fused)


def layer1_words(torch, sess_u, sess_f, tol):
    """GCN "bin" layer 1 of the distributed pass, unfused against fused:
    the exchanged transform words of every shard (cuBLAS fp32 GEMM against
    the fused kernel's fmaf chain) and the layer's output words. Output
    words must be equal on every row that aggregates no neighbour whose
    transform words differ, and a transform bit may differ only where its
    fp64 value is within FP_TOL of its sum of |terms|. Returns the counts
    of (differing transform bits, rows they reach, differing output
    rows)."""
    import numpy as np
    from repro_torch.core import bitops
    from repro_torch.graphs import sampling
    from repro_torch.serve import session_core
    ex_u, ex_f = sess_u.layer_executor, sess_f.layer_executor
    step_u, step_f = sess_u.program[0], sess_f.program[0]
    bn = tuple(t.to(ex_u.device) for t in sess_u.bn[0])
    states = ex_u._pad_state(sess_u._x_blocks())
    hb_u = torch.cat([ex_u._operand(step_u, st, bn)[:p.n_local]
                      for st, p in zip(states, sess_u.parts)])
    hb_f = torch.cat([ex_f._operand(step_f, st, bn)[:p.n_local]
                      for st, p in zip(states, sess_f.parts)])
    out_u = np.concatenate(ex_u.run_pass(sess_u.program[:1],
                                         sess_u._x_blocks(), sess_u.bn)[0])
    out_f = np.concatenate(ex_f.run_pass(sess_f.program[:1],
                                         sess_f._x_blocks(), sess_f.bn)[0])
    w = sess_u.qparams.w1
    n_h = w.packed.shape[0]
    diff = (bitops.unpack_bits(hb_u, n_h) != bitops.unpack_bits(hb_f, n_h))
    nodes, feats = torch.nonzero(diff, as_tuple=True)
    if nodes.numel():
        x = torch.from_numpy(sess_u.graph.data.x).to(bn[0].device)
        z = session_core.apply_bn(x[nodes], *bn).double()
        w_eff = (bitops.unpack_pm1(w.packed, w.n) * w.scale).T.double()
        v = (z * w_eff[:, feats].T).sum(1)
        mag = (z.abs() * w_eff[:, feats].T.abs()).sum(1)
        if bool((v.abs() > tol * mag).any()):
            raise AssertionError("layer 1: a transform bit differs away from "
                                 "zero between the unfused and fused passes")
    diff_nodes = np.unique(nodes.cpu().numpy())
    reached = np.zeros(out_u.shape[0], bool)
    if diff_nodes.size:
        receivers, _ = sampling.gather_neighbors(sess_u.graph.csr_rev,
                                                 diff_nodes)
        reached[receivers] = True
    rows = (out_u != out_f).any(axis=1)
    if bool((rows & ~reached).any()):
        raise AssertionError("layer 1: output words differ on rows whose "
                             "neighbours' transform words agree")
    return int(diff.sum()), int(reached.sum()), int(rows.sum())


def run_sharded(torch, flickr, single, params) -> list:
    """Phases 8-10: sharded serving on full Flickr, SHARDS shards on the
    one card, executor="host". Returns the records of the fused layer's
    sharded forms (rows 7e-7h) and the store of the routed GCN "bin"
    session."""
    import tempfile
    from functools import partial

    import numpy as np
    from repro_torch.core import bitops
    from repro_torch.core.binarize import BinTensor
    from repro_torch.kernels import fused_layer, ops
    from repro_torch.serve import GraphStore, session_core
    from repro_torch.serve.sharded import ShardedGraphSession, ShardPlanner

    dev = DEVICE
    rng = np.random.default_rng(SEED + 3)
    t_start = time.perf_counter()
    n_fl, f_fl = flickr.x.shape
    n_cls = flickr.n_classes

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # -- 8. the sharded main path: plans, distributed passes, routed serve --
    t0 = time.perf_counter()
    plans = {fam: ShardPlanner(SHARDS).plan(flickr, fam)
             for fam in ("gcn", "sage", "saint")}
    log(f"shard plans ({SHARDS} shards): {time.perf_counter() - t0:.1f} s; "
        + json.dumps({fam: dict(
            pl.stats(), n_local_pad=pl.spmd_plan().n_local_pad,
            n_halo_pad=pl.spmd_plan().n_halo_pad,
            intra_groups=pl.spmd_plan().intra_groups,
            halo_groups=pl.spmd_plan().halo_groups)
            for fam, pl in plans.items()}))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    store = GraphStore(max_batch=SERVE_BATCH, khop=2, use_pallas=True,
                       device=dev)
    store.register_graph("flickr", flickr)
    for fam in ("gcn", "sage", "saint"):
        store.register_model(fam, fam, params[fam])
    graph = store.graphs["flickr"]
    sessions = {"gcn_bin/unfused": store.sharded_session("flickr", "gcn",
                                                          SHARDS)}
    for name, (fam, scheme, fused) in SHARDED_WAYS.items():
        if name not in sessions:
            sess = ShardedGraphSession(
                graph, store.models[fam],
                sharded_plan(session_core, fam, scheme, fused),
                session_core.quantize_family(fam, params[fam]), plans[fam],
                khop=2, max_batch=SERVE_BATCH, use_pallas=True, device=dev)
            sess.sync()
            sessions[name] = sess
    passes = {name: np.concatenate(sess.run_distributed_pass())
              for name, sess in sessions.items()}
    # routed serve: the owner groups of 4 batches of 32 seeded seeds, every
    # serve core (and the single-host one) at the node cap
    routed = sessions["gcn_bin/unfused"]
    for core in routed.cores + [single.core]:
        core.preset_water(core.node_cap, {}, 1.0)
    routed.warmup(np.random.default_rng(SEED), probes=ROUTED_PROBES)
    programs = routed.compile_count_by_shard
    seeds = rng.integers(0, n_fl, size=(ROUTED_BATCHES, SERVE_BATCH))
    served, serve_times = [], []
    for batch in seeds:
        t1 = time.perf_counter()
        served.append(routed.serve_subgraph(batch))
        serve_times.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    log(f"sharded main path: {time.perf_counter() - t0:.1f} s; launches "
        + json.dumps(launches))
    need = list(FORWARD_KERNELS) + ["fused_layer"] \
        + [f"fused_layer/{k}" for k in PAIR_KINDS]
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"sharded path: kernels never launched: "
                             f"{missing}")

    # -- 9. checks ----------------------------------------------------------
    t0 = time.perf_counter()
    x_dev = card(flickr.x)

    # each distributed pass against the card's single-host full-graph
    # forward under the same frozen BN
    for name, sess in sessions.items():
        fam, scheme, _ = SHARDED_WAYS[name]
        want = session_core.family_forward(
            sharded_plan(session_core, fam, scheme, False), sess.qparams,
            x_dev, sess._adj_full, use_pallas=True, bn_stats=sess.bn)
        if passes[name].shape != tuple(want.shape) \
                or not np.isfinite(passes[name]).all():
            raise AssertionError(f"sharded {name}: logits "
                                 f"{passes[name].shape} not finite of shape "
                                 f"{tuple(want.shape)}")
        agree(f"sharded {name} vs the single-host forward", passes[name],
              want.cpu().numpy())
    agree("sharded gcn_bin fused vs unfused", passes["gcn_bin/fused"],
          passes["gcn_bin/unfused"])
    bn_u, bn_f = sessions["gcn_bin/unfused"].bn, sessions["gcn_bin/fused"].bn
    if not all(torch.equal(a, b) for sa, sb in zip(bn_u, bn_f)
               for a, b in zip(sa, sb)):
        raise AssertionError("sharded gcn_bin: calibrations differ")
    flips, reached, rows = layer1_words(
        torch, sessions["gcn_bin/unfused"], sessions["gcn_bin/fused"], FP_TOL)
    log(f"sharded gcn_bin layer-1 words, unfused vs fused: {flips} "
        f"transform bits differ (each within {FP_TOL} of its sum of |terms| "
        f"from zero), reaching {reached} rows; {rows} output rows differ, "
        f"all among those")
    # routed serve: bit-exact against the single-host card session for the
    # same per-owner micro-batches, no program added after warmup
    if not all(torch.equal(a, b) for sa, sb in zip(routed.bn, single.bn)
               for a, b in zip(sa, sb)):
        raise AssertionError("routed serve: the sharded and single-host "
                             "calibrations differ")
    groups = 0
    for batch, got in zip(seeds, served):
        owners = routed.routing.owner(batch)
        for o in np.unique(owners):
            sel = owners == o
            if not np.array_equal(got[sel], single.serve_subgraph(batch[sel])):
                raise AssertionError(f"routed serve: owner {o}'s answers "
                                     f"differ from the single-host session")
            groups += 1
    if routed.compile_count_by_shard != programs:
        raise AssertionError(f"routed serve: programs {programs} -> "
                             f"{routed.compile_count_by_shard} after warmup")
    split = []
    for batch in seeds[:2]:
        t1 = time.perf_counter()
        prep = routed.prepare_batch(batch)
        t2 = time.perf_counter()
        routed.finish_batch(prep, routed.launch_batch(prep))
        split.append(((t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3))
    split = tuple(float(np.median(v)) for v in zip(*split))
    log(f"routed serve: {ROUTED_BATCHES} batches of {SERVE_BATCH} seeds, "
        f"{groups} owner groups bit-exact against the single-host session; "
        f"programs per shard {programs}, none added; per batch p50 "
        f"{float(np.percentile(serve_times, 50)):.3f} ms, p90 "
        f"{float(np.percentile(serve_times, 90)):.3f} ms; extract "
        f"{split[0]:.3f} ms, launch + finish {split[1]:.3f} ms; halo bytes "
        f"serve/x {routed.halo_stats.bytes_by_tag.get('serve/x', 0)}")
    # artifact round trip
    with tempfile.TemporaryDirectory() as tmp:
        routed.save(Path(tmp) / "flickr__gcn__P4")
        loaded = ShardedGraphSession.load(
            Path(tmp) / "flickr__gcn__P4", graph, store.models["gcn"], khop=2,
            max_batch=SERVE_BATCH, use_pallas=True, device=dev)
        if loaded is None:
            raise AssertionError("sharded artifact did not restore")
        for core in loaded.cores:
            core.preset_water(core.node_cap, {}, 1.0)
        if not np.array_equal(loaded.serve_subgraph(seeds[0]), served[0]) \
                or not np.array_equal(loaded.full_logits(),
                                      routed.full_logits()):
            raise AssertionError("restored sharded artifact answers differ")
    log(f"sharded checks: {time.perf_counter() - t0:.1f} s")

    # -- 10. times: passes, and the pair kernels at one shard's shapes ------
    pass_ms, halo_bytes, pass_launches = {}, {}, {}
    for name, sess in sessions.items():
        pass_ms[name] = host_ms(torch, sess.run_distributed_pass, iters=3)
        before = dict(sess.halo_stats.bytes_by_tag)
        ops.reset_launch_counts()
        sess.run_distributed_pass()
        pass_launches[name] = {k: v for k, v in ops.launch_counts().items()
                               if v}
        halo_bytes[name] = {t: b - before.get(t, 0)
                            for t, b in sess.halo_stats.bytes_by_tag.items()
                            if b - before.get(t, 0)}
    ex = routed.layer_executor
    upload_ms = host_ms(torch, lambda: ex._pad_state(routed._x_blocks()),
                        iters=3)
    log("sharded distributed pass ms (host clock, median of 3): "
        + json.dumps(pass_ms) + f"; of which the upload of the padded "
        f"feature blocks (pageable host memory) {upload_ms:.3f} ms")
    log("sharded halo bytes a pass, by tag: " + json.dumps(halo_bytes))
    log("sharded launches a pass: " + json.dumps(pass_launches))

    err = {f"fused_layer/{k}": 0.0 for k in PAIR_KINDS}

    def ints(shape, lo=-3, hi=4):
        return card(rng.integers(lo, hi, shape).astype(np.float32))

    def weights(n_out, n_in):
        return BinTensor(bitops.pack_bits(card(rng.integers(0, 2, (n_out,
                                                                   n_in)))),
                         card(rng.choice([0.25, 0.5, 1.0], (n_out, 1))
                              .astype(np.float32)), n_in)

    def bn_of(f):
        return (ints((1, f), -1, 2), card(rng.choice([1.0, 2.0], (1, f))
                                          .astype(np.float32)))

    def shard0(name, kind):
        ex = sessions[name].layer_executor
        return ex._intra[kind][0], ex._halo[kind][0], ex._items[kind][0]

    fl = fused_layer
    # name: (shape, call, plain, sum of |terms| or None, sign bits or None,
    # bound); the calls bind their inputs now (partial), as the names are
    # rebound from one form to the next
    specs = {}
    # 7e: GCN "bin" layer 1, 500 -> 64 words over the 0/1 pair
    a, h, it = shard0("gcn_bin/fused", "bin")
    npd, nhp = a.n_rows, h.n_cols
    wh = -(-HIDDEN // 32)
    x, bn, w1 = ints((npd, f_fl)), bn_of(f_fl), weights(HIDDEN, f_fl)
    rem_w = bitops.pack_bits(card(rng.integers(0, 2, (nhp, HIDDEN))))
    wk_f = bitops.padded_words(f_fl)
    adj_bytes = (group_bytes(a) + group_bytes(h)
                 + 4 * (a.n_tile_rows + 1) * 2)
    specs["gcn_bin_l1+halo"] = (
        f"shard 0 ({npd} rows, halo {nhp}): ({npd}, {f_fl}) -> ({npd}, {wh}) "
        f"words, intra {real_groups(a)} + halo {real_groups(h)} groups, "
        f"{a.nnz} + {h.nnz} edges",
        partial(fl.gcn_bin_l1, x, bn, w1, a, item_ptr=it[0], halo=h,
                rem=rem_w, halo_items=it[1], bn_rcp=True),
        partial(fl.gcn_bin_l1_plain, x, bn, w1, a, halo=h, rem=rem_w,
                bn_rcp=True),
        None, HIDDEN,
        bound(4 * npd * f_fl + 8 * f_fl + 4 * HIDDEN * (wk_f + 1) + adj_bytes
              + 4 * nhp * wh + 4 * npd * wh,
              [(2 * npd * f_fl * HIDDEN, FP32_OPS_PER_S),
               (2 * (a.nnz + h.nnz) * HIDDEN, INT8_TC_OPS_PER_S)]))
    # 7f: GCN "full" layer 1, 500 -> 64 over the scaled pair, ReLU
    a, h, it = shard0("gcn_full/fused", "adj")
    x, bn, wf = ints((npd, f_fl)), bn_of(f_fl), weights(HIDDEN, f_fl)
    rem = ints((h.n_cols, HIDDEN))
    words, xs = fl._input(x, bn, True)
    y = fl._bbf(words, xs, wf)
    scale_bytes = 8 * npd + 4 * h.n_cols
    specs["gcn_bbf_fbf+halo"] = (
        f"shard 0 GCN full layer 1: ({npd}, {f_fl}) -> ({npd}, {HIDDEN}), "
        f"intra {real_groups(a)} + halo {real_groups(h)} groups, "
        f"{a.nnz} + {h.nnz} edges, rem ({h.n_cols}, {HIDDEN})",
        partial(fl.gcn_bbf_fbf, x, bn, wf, a, True, it[0], h, rem, it[1],
                True),
        partial(fl.gcn_bbf_fbf_plain, x, bn, wf, a, True, h, rem, True),
        fl.agg_fp_pair(a, h, y.abs(), rem.abs()), None,
        bound(4 * npd * f_fl + 8 * f_fl + 4 * HIDDEN * (wk_f + 1)
              + group_bytes(a) + group_bytes(h) + 8 * (a.n_tile_rows + 1)
              + scale_bytes + 4 * h.n_cols * HIDDEN + 4 * npd * HIDDEN,
              [(2 * npd * HIDDEN * f_fl, INT8_TC_OPS_PER_S),
               (2 * npd * f_fl, FP32_OPS_PER_S),
               (2 * (a.nnz + h.nnz) * HIDDEN, FP32_OPS_PER_S)]))
    # GCN "bin" layer 2 (words 64 -> 7) with its pair: parity only
    a2, h2, it2 = shard0("gcn_bin/fused", "adj")
    hw = bitops.pack_bits(card(rng.integers(0, 2, (npd, HIDDEN))))
    w2 = weights(n_cls, HIDDEN)
    rem7 = ints((h2.n_cols, n_cls))
    y2 = fl._bbf(*fl._input(hw, None), w2)
    words_case = (
        partial(fl.gcn_bbf_fbf, hw, None, w2, a2, False, it2[0], h2, rem7,
                it2[1]),
        partial(fl.gcn_bbf_fbf_plain, hw, None, w2, a2, False, h2, rem7),
        fl.agg_fp_pair(a2, h2, y2.abs(), rem7.abs()))
    # 7g: SAGE layer 1, 500 -> 64, self + mean pair, ReLU
    a, h, it = shard0("sage/fused", "mean")
    x, bn = ints((npd, f_fl)), bn_of(f_fl)
    ws, wa = weights(HIDDEN, f_fl), weights(HIDDEN, f_fl)
    rem = ints((h.n_cols, HIDDEN))
    words, xs = fl._input(x, bn, True)
    mag = fl._bbf(words, xs, ws).abs() + fl.agg_fp_pair(
        a, h, fl._bbf(words, xs, wa).abs(), rem.abs())
    specs["branch_add+halo"] = (
        f"shard 0 SAGE layer 1: ({npd}, {f_fl}) -> ({npd}, {HIDDEN}), self + "
        f"mean pair, intra {real_groups(a)} + halo {real_groups(h)} groups, "
        f"{a.nnz} + {h.nnz} edges",
        partial(fl.branch_add, x, bn, ws, wa, a, True, it[0], h, rem, it[1],
                True),
        partial(fl.branch_add_plain, x, bn, ws, wa, a, True, h, rem, True),
        mag, None,
        bound(4 * npd * f_fl + 8 * f_fl + 8 * HIDDEN * (wk_f + 1)
              + group_bytes(a) + group_bytes(h) + 8 * (a.n_tile_rows + 1)
              + 4 * npd + 4 * h.n_cols * HIDDEN + 4 * npd * HIDDEN,
              [(4 * npd * HIDDEN * f_fl, INT8_TC_OPS_PER_S),
               (2 * npd * f_fl, FP32_OPS_PER_S),
               (2 * (a.nnz + h.nnz) * HIDDEN, FP32_OPS_PER_S)]))
    # 7h: SAINT's fc, 64 -> 7, BN by the reciprocal (no aggregation)
    xh, bnh, wc = ints((npd, HIDDEN)), bn_of(HIDDEN), weights(n_cls, HIDDEN)
    wk_h = bitops.padded_words(HIDDEN)
    specs["fc+rcp"] = (
        f"shard 0 SAINT fc: ({npd}, {HIDDEN}) -> ({npd}, {n_cls})",
        partial(fl.fc, xh, bnh, wc, bn_rcp=True),
        partial(fl.fc_plain, xh, bnh, wc, bn_rcp=True),
        fl._bbf(*fl._input(xh, bnh, True), wc).abs(), None,
        bound(4 * npd * HIDDEN + 8 * HIDDEN + 4 * n_cls * (wk_h + 1)
              + 4 * npd * n_cls,
              [(2 * npd * n_cls * HIDDEN, INT8_TC_OPS_PER_S),
               (2 * npd * HIDDEN, FP32_OPS_PER_S)]))

    def hold(kernel, got, want, n_bits=None, magnitude=None):
        hold_to(torch, err, kernel, got, want, n_bits, magnitude)

    cases = 0
    for kind, (_, call, plain, mag, n_bits, _) in specs.items():
        got = call()
        hold(f"fused_layer/{kind}", got, call())          # deterministic
        hold(f"fused_layer/{kind}", got, plain(), n_bits=n_bits,
             magnitude=mag)
        cases += 2
    got = words_case[0]()
    hold("fused_layer/gcn_bbf_fbf+halo", got, words_case[0]())
    hold("fused_layer/gcn_bbf_fbf+halo", got, words_case[1](),
         magnitude=words_case[2])
    cases += 2
    torch.cuda.synchronize()
    log(f"parity (sharded forms of the fused layer): {cases} cases passed; "
        f"max abs err " + json.dumps(err))
    records = []
    for kind, (shape, call, plain, _, _, b) in specs.items():
        name = f"fused_layer/{kind}"
        records.append(kernel_record(
            name, shape, launches[name], err[name], cuda_ms(torch, call),
            cuda_ms(torch, plain, iters=5, warmup=1), None, b))
    log("device ms (torch.profiler), sharded forms at shard 0: " + json.dumps(
        {kind: device_ms(torch, call)
         for kind, (_, call, _, _, _, _) in specs.items()}))
    log(f"phases 8-10: {time.perf_counter() - t_start:.1f} s")
    return records, store


def run_engine(torch, flickr, stores, sharded_store, single) -> dict:
    """Phases 11-12: the node-query engines on full Flickr, on the GCN
    stores of phase 6 and the sharded store of phase 8. Returns the kernel
    launches of the engine paths by kernel name."""
    import traceback

    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import (AdmissionController, GNNServeEngine,
                                   ShardedServeEngine, TenantPolicy)

    t_start = time.perf_counter()
    n_fl = flickr.n_nodes
    launches: dict = {}

    def counted(path, expect, fn):
        """Drive one engine path with the launch counts set to 0 just
        before it and read just after; fail if a kernel of ``expect``
        never launched."""
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        missing = [k for k in expect if counts[k] == 0]
        if missing:
            raise AssertionError(f"{path}: kernels never launched: {missing}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out, counts

    def stats(eng, d0):
        snap = eng.snapshot()
        return dict(qps=snap["qps"], p50_ms=snap["latency"]["p50_ms"],
                    p99_ms=snap["latency"]["p99_ms"],
                    extract_s=eng.metrics.extract_s,
                    compute_s=eng.metrics.compute_s,
                    overlap_ratio=snap["overlap_ratio"],
                    batches=snap["batches"],
                    dispatches=eng.dispatch_count - d0)

    def drain(eng, nodes, **kw):
        def go():
            qs = eng.submit_many("flickr", "gcn", nodes, **kw)
            eng.run_until_drained()
            return qs
        return go

    # -- 11. the single-host engine on way (c)'s store ----------------------
    st_c = stores["c"]
    sess_c = st_c.session("flickr", "gcn")
    nodes = np.random.default_rng(SEED + 5).integers(
        0, n_fl, size=ENGINE_BATCHES * SERVE_BATCH)
    runs = {"depth 0": dict(pipeline_depth=0),
            "depth 1": dict(pipeline_depth=1),
            "depth 2": dict(pipeline_depth=2),
            "depth 2 multi_bucket": dict(pipeline_depth=2, multi_bucket=True)}
    results = {}
    for name, kw in runs.items():
        eng = GNNServeEngine(st_c, max_batch=SERVE_BATCH, mode="subgraph",
                             **kw)
        eng.warmup("flickr", "gcn", probes=ENGINE_PROBES)
        d0 = eng.dispatch_count
        qs, counts = counted(f"engine {name}", ("fused_layer",),
                             drain(eng, nodes))
        eng.close()
        if not all(q.done for q in qs):
            raise AssertionError(f"engine {name}: queries unanswered")
        n_b = eng.metrics.batches
        others = {k: v for k, v in counts.items() if k != "fused_layer" and v}
        if counts["fused_layer"] != 2 * n_b or others:
            raise AssertionError(f"engine {name}: launched {counts} for "
                                 f"{n_b} batches, want 2 fused a batch")
        # warmup launches single batches, so with multi_bucket a co-launch
        # of K = 2..depth batches of the one steady bucket is a composition
        # it skipped, and a new program after it (the reference's jit
        # traces it there too); without, none may appear
        steady = [e.attrs["shape"] for e in eng.tracer.warning_events()
                  if e.name == "recompile"]
        wd = eng.recompile_watchdog.steady_recompiles
        skipped = kw["pipeline_depth"] - 1 if kw.get("multi_bucket") else 0
        if wd != len(steady) or any("multi" not in sh for sh in steady) \
                or wd > skipped:
            raise AssertionError(f"engine {name}: steady-state programs "
                                 f"{steady}")
        results[name] = dict(qs=qs, logits=np.stack([q.logits for q in qs]),
                             log=[[q.qid for q in b] for b in eng.batch_log],
                             stats=dict(stats(eng, d0),
                                        steady_new_programs=wd))
        log(f"engine {name}: " + json.dumps(results[name]["stats"]))
    base = results["depth 0"]
    for name, r in results.items():
        if r["log"] != base["log"] \
                or not np.array_equal(r["logits"], base["logits"]):
            raise AssertionError(f"engine {name}: batches or answers differ "
                                 f"from the serial engine's")
    by_qid = {q.qid: q for q in base["qs"]}
    for batch in base["log"]:
        seeds = np.asarray([by_qid[i].node for i in batch])
        if not np.array_equal(np.stack([by_qid[i].logits for i in batch]),
                              sess_c.serve_subgraph(seeds)):
            raise AssertionError("engine answers differ from way (c)'s "
                                 "serve_subgraph on the same batch")
    agree("engine vs the card's full-graph forward", base["logits"],
          sess_c.full_logits()[nodes])
    multi = results["depth 2 multi_bucket"]["stats"]
    if not multi["dispatches"] < multi["batches"]:
        raise AssertionError(f"multi_bucket: {multi['dispatches']} "
                             f"dispatches for {multi['batches']} batches")
    log(f"engine: {len(runs)} runs of {nodes.size} queries, batch_log and "
        f"answers identical, bit-equal to way (c)'s serve_subgraph on "
        f"{len(base['log'])} replayed batches; "
        f"{time.perf_counter() - t_start:.1f} s")

    # one depth-1 drain on way (a)'s store with the launch stage inside
    # the transfer watchdog's strict guard (CUDA sync debug mode "error")
    class Guarded(GNNServeEngine):
        def _launch_stage(self, inf):
            with self.transfer_watchdog.strict_guard():
                super()._launch_stage(inf)

    t0 = time.perf_counter()
    guarded = Guarded(stores["a"], max_batch=SERVE_BATCH, mode="subgraph",
                      pipeline_depth=1, max_retries=1, retry_backoff_s=0.0)
    guarded.warmup("flickr", "gcn", probes=ENGINE_PROBES)
    errors = []

    def sync_error(text):
        # the error torch's sync debug mode raises, and nothing else
        return "synchroniz" in text

    def guarded_drain():
        qs = guarded.submit_many("flickr", "gcn", nodes)
        for _ in range(4 * ENGINE_BATCHES):
            try:
                guarded.run_until_drained()
                break
            except RuntimeError as e:
                if not sync_error(str(e)):
                    raise
                errors.append("".join(traceback.format_exception(e)[-4:]))
        return qs

    qs, counts = counted("guarded engine (a)", (), guarded_drain)
    guarded.close()
    answered = [q for q in qs if q.done]
    lost = [q.qid for q in qs if not q.done and not (
        q.failed and sync_error(q.failure.error))]
    if lost:
        raise AssertionError(f"guarded engine (a): {len(lost)} queries "
                             f"neither answered nor failed by the guard")
    if answered and [k for k in FORWARD_KERNELS if counts[k] == 0]:
        raise AssertionError(f"guarded engine (a): launched {counts}")
    if answered:
        agree("guarded engine (a) vs the card's full-graph forward",
              np.stack([q.logits for q in answered]),
              single.full_logits()[[q.node for q in answered]])
    log(f"strict guard, depth 1 on way (a): watchdog "
        + json.dumps(guarded.transfer_watchdog.snapshot())
        + f"; {len(answered)} answered, "
        f"{sum(q.failed for q in qs)} failed, {len(errors)} guard errors; "
        f"{time.perf_counter() - t0:.1f} s")
    if errors:
        log("strict guard, first error:\n" + errors[0])

    # traced against untraced QPS at depth 1, best of 3 each (not gated)
    t0 = time.perf_counter()
    qps = {"traced": [], "untraced": []}
    for _ in range(3):
        for name, trace in (("traced", True), ("untraced", False)):
            eng = GNNServeEngine(st_c, max_batch=SERVE_BATCH,
                                 mode="subgraph", pipeline_depth=1,
                                 trace=trace)
            drain(eng, nodes[:QPS_BATCHES * SERVE_BATCH])()
            eng.close()
            qps[name].append(eng.metrics.qps)
    log("tracing overhead, depth 1, QPS best of 3: " + json.dumps(
        dict(traced=max(qps["traced"]), untraced=max(qps["untraced"]),
             ratio=max(qps["traced"]) / max(qps["untraced"]), runs=qps))
        + f"; {time.perf_counter() - t0:.1f} s")

    # a full-cache multi-tenant run: a rate-limited hog beside gold
    t0 = time.perf_counter()
    adm = AdmissionController(policies={
        "hog": TenantPolicy(rate_qps=2000.0, burst=96, max_queue_depth=64),
        "gold": TenantPolicy(weight=4)})
    eng = GNNServeEngine(st_c, max_batch=SERVE_BATCH, mode="full",
                         admission=adm)
    eng.warmup("flickr", "gcn")
    rng = np.random.default_rng(SEED + 7)
    qs = []
    for _ in range(8):
        qs += eng.submit_many("flickr", "gcn", rng.integers(0, n_fl, 96),
                              tenant="hog")
        qs += eng.submit_many("flickr", "gcn", rng.integers(0, n_fl, 16),
                              tenant="gold")
        eng.tick()
        eng.tick()
    eng.run_until_drained()
    done = [q for q in qs if q.done]
    if not all(q.done or q.rejected for q in qs) or not np.array_equal(
            np.stack([q.logits for q in done]),
            sess_c.full_logits()[[q.node for q in done]]):
        raise AssertionError("multi-tenant run: answers differ from "
                             "full_logits()")
    tenants = eng.snapshot()["tenants"]
    log("multi-tenant full cache: " + json.dumps({
        t: dict(accepted=v["accepted"], throttled=v["throttled"],
                shed=v["shed"], p99_ms=v["latency"]["p99_ms"])
        for t, v in tenants.items()})
        + f"; {time.perf_counter() - t0:.1f} s")

    # -- 12. the sharded engine on the routed GCN "bin" session ------------
    t0 = time.perf_counter()
    sess_r = sharded_store.sharded_session("flickr", "gcn", SHARDS)
    sharded = ShardedServeEngine(sharded_store, n_shards=SHARDS,
                                 max_batch=SERVE_BATCH, pipeline_depth=1)
    sharded.warmup("flickr", "gcn", probes=ROUTED_PROBES)
    programs = sess_r.compile_count_by_shard
    d0 = sharded.dispatch_count
    r_nodes = np.random.default_rng(SEED + 6).integers(0, n_fl,
                                                       size=ROUTED_QUERIES)
    qs, counts = counted("sharded engine", FORWARD_KERNELS,
                         drain(sharded, r_nodes))
    sharded.close()
    if not all(q.done for q in qs):
        raise AssertionError("sharded engine: queries unanswered")
    for batch in sharded.batch_log:
        seeds = np.asarray([q.node for q in batch])
        if np.unique(sess_r.routing.owner(seeds)).size != 1 \
                or not np.array_equal(np.stack([q.logits for q in batch]),
                                      single.serve_subgraph(seeds)):
            raise AssertionError("sharded engine: a batch is not one owner "
                                 "group bit-exact against way (a)")
    if sess_r.compile_count_by_shard != programs \
            or sharded.recompile_watchdog.steady_recompiles:
        raise AssertionError(f"sharded engine: programs {programs} -> "
                             f"{sess_r.compile_count_by_shard} after warmup")
    snap = sharded.snapshot()
    log("sharded engine: " + json.dumps(dict(
        stats(sharded, d0), halo_tiles_shared=snap["halo_tiles_shared"],
        halo_bytes_saved=snap["halo_bytes_saved"],
        compiles_by_shard=snap["compiles_by_shard"],
        routed_p50_ms=snap["latency"]["p50_ms"], launches=counts))
        + f"; {len(sharded.batch_log)} batches bit-exact against way (a) "
        f"per owner group; {time.perf_counter() - t0:.1f} s")
    log(f"phases 11-12: {time.perf_counter() - t_start:.1f} s")
    return launches


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
