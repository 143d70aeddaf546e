#!/usr/bin/env python3
"""Where the bits FRDC aggregation spends its device time, and a bit-for-bit
hold of its outputs across two trees: the measurement behind the redesign
of the bits walk (``bspmm_bits``, ``bspmm_bits_grid`` and the fused
``gcn_bin_l1``'s counts aggregation).

Run from the repository root on a machine with one NVIDIA GPU, on this
tree or on another one (``--tree``, e.g. an earlier commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists):

    python3 tools/bits_step0.py [--tree scratch_chip/parent]
        [--save scratch_chip/bits.json | --compare scratch_chip/bits.json]

1. device ms (torch.profiler) and CUDA-event ms, each twice in turns, of
   ``bspmm_bits`` on full Flickr's 0/1 FRDC at F = 64 (counts and
   binarize, s3 and s2) and on Reddit x0.1 (counts, s3);
   ``bspmm_bits_grid`` at the serve bucket of full Flickr (GCN "bin" serve
   session, 32 seeds, 2 hops) with block (32, 32) and a full-width block;
   the fused ``gcn_bin_l1`` there, whole and transform-only
   (``chip_smoke.transform_only``);
2. the same launches from variant builds of the tree's kernels (outputs
   wrong, timing only): ``transpose cut``, the bit transpose of the walk
   replaced by the gathered word itself (the 32-ballot loop of the
   per-word walk, or the butterfly's ``transpose32``), and ``hub rows
   skipped``, the bits grid without its tile-rows of more than 32 groups
   (the per-CTA split of the old grid kernel, or the chunk CTAs of the new
   one);
3. ptxas' registers and spills of ``bspmm.cu``, ``bspmm_grid.cu`` and
   ``fused_layer.cu``.

``--save`` writes the shape, dtype and SHA-256 of every output of section 1
and of edge cases (hub rows, empty rows, a ``pad_frdc`` bucket, F in {7,
100, 160}, several blocks) on seeded inputs, with a digest of the inputs,
to a JSON file; ``--compare`` reads such a file, written by another tree,
and fails unless every output is bit-equal (the same digest).
"""
import contextlib
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = Path(sys.argv[sys.argv.index("--tree") + 1]).resolve() \
    if "--tree" in sys.argv else HERE
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(HERE))
sys.path.insert(2, str(HERE / "tools"))

from repro_torch.core import bitops, frdc  # noqa: E402
from repro_torch.core.binarize import BinTensor  # noqa: E402
from repro_torch.graphs.datasets import make_dataset  # noqa: E402
from repro_torch.kernels import bspmm_kernel, build, fused_layer  # noqa: E402
from chip_smoke import cuda_ms, device_ms, transform_only  # noqa: E402
from xform_step0 import serve_bucket  # noqa: E402

SEED = 0
HIDDEN = 64
S3, S2 = "s3_two_popc", "s2_and_andnot"
bk = bspmm_kernel
dev = "cuda"
CSRC = ROOT / "src/repro_torch/csrc"
VARIANTS = ROOT / "src/repro_torch/_build/bits_step0"
# the 32-ballot transpose of the per-word walk, and the butterfly
BALLOT_LOOP = """      for (int f = 0; f < 32; ++f) {
        const uint32_t b = __ballot_sync(kFull, (xk[q] >> f) & 1u);
        if (lane == f) bt = b;
      }"""
BUTTERFLY = "__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {"
# the old grid kernel's per-CTA hub loop, and the new launch's chunk CTAs
HUB_LOOP = "  for (int tr = tr0; tr < tr1; ++tr) {\n    const int g0 = grp_ptr[tr], n_g"
HUB_END = "\n}\n\n// The fp grid"
CHUNK_CTAS = "  const int k = (int)blockIdx.x * kBlockWarps + warp;"


def transpose_cut(walk: str):
    if BALLOT_LOOP in walk:
        return walk.replace(BALLOT_LOOP, "      bt = xk[q];")
    if BUTTERFLY in walk:
        return walk.replace(BUTTERFLY, BUTTERFLY + "\n  return x;")
    return None


def hub_cut(walk: str, grid: str):
    """(walk.cuh, bspmm_grid.cu) with the bits grid's hub rows skipped."""
    if HUB_LOOP in grid:
        start = grid.index(HUB_LOOP)
        return walk, grid[:start] + grid[grid.index(HUB_END, start):]
    if CHUNK_CTAS in walk:    # the chunk CTAs return at once
        return walk.replace(CHUNK_CTAS, CHUNK_CTAS + "\n  if (k >= 0) return;"), grid
    return None


def compile_variants(plans):
    """Builds variant libraries, one nvcc a source, all started together:
    ``plans`` maps a name to (walk.cuh text, sources, {source: edited .cu
    text}); returns {name: {source: loaded library}}."""
    procs = []
    for name, (w, sources, edited) in plans.items():
        d = VARIANTS / name.replace(" ", "_").replace("=", "")
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob("*.cuh"):
            (d / h.name).write_text(w if h.name == "walk.cuh" else h.read_text())
        for s in sources:
            (d / f"{s}.cu").write_text(edited.get(s, (CSRC / f"{s}.cu").read_text()))
            procs.append((name, s, d / f"{s}.so", subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / f"{s}.so"),
                 str(d / f"{s}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, s, so, p in procs:
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"variant {name} / {s} failed:\n{log}")
        libs.setdefault(name, {})[s] = build._load(s, so)
    return libs


def build_variants():
    """{variant: {source: loaded library}} of the cuts this tree has."""
    walk = (CSRC / "walk.cuh").read_text()
    grid = (CSRC / "bspmm_grid.cu").read_text()
    plans = {}
    cut = transpose_cut(walk)
    if cut is not None:
        plans["transpose cut"] = (cut, ("bspmm", "bspmm_grid", "fused_layer"), {})
    hub = hub_cut(walk, grid)
    if hub is not None:
        plans["hub rows skipped"] = (hub[0], ("bspmm_grid",), {"bspmm_grid": hub[1]})
    return compile_variants(plans)


def source_of(name):
    """The library a timed launch of ``main_path_calls`` runs."""
    return ("fused_layer" if name.startswith("gcn_bin_l1") else
            "bspmm_grid" if "grid" in name else "bspmm")


@contextlib.contextmanager
def swapped(libs):
    """The wrappers launch the given libraries while active."""
    real = {s: build.library(s) for s in libs}
    build._LIBS.update(libs)
    try:
        yield
    finally:
        build._LIBS.update(real)


def ptxas_report():
    """Registers and spills of the bits kernels and the fused kernel."""
    for name in ("bspmm", "bspmm_grid", "fused_layer"):
        r = subprocess.run([build.nvcc_path(), "-gencode",
                            "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                            "-Xptxas", "-v", "-c", "-o", "/dev/null",
                            str(CSRC / f"{name}.cu")], capture_output=True,
                           text=True)
        entry = ""
        for line in (r.stdout + r.stderr).splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif ("registers" in line or "spill" in line) and (
                    "bits" in entry or name == "fused_layer"):
                print(f"ptxas {name} {entry}: {line.strip()}")


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(str((tuple(t.shape), t.dtype)).encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def edge_cases(rng):
    """Small FRDCs: 3 x 3 ones (N < 4), a graph with a hub tile-row of 40
    groups and empty tile-rows, and its pad_frdc bucket."""
    n = 1403
    rows = [rng.integers(32, 200, 400)]
    cols = [rng.integers(0, n, 400)]
    tc = rng.permutation(-(-n // 4))[:8 * 40]
    rows.append(4 + rng.integers(0, 4, tc.size))
    cols.append(np.minimum(tc * 4 + rng.integers(0, 4, tc.size), n - 1))
    hub = frdc.from_coo(np.concatenate(rows), np.concatenate(cols), n, n,
                        device=dev)
    return {"ones3": frdc.from_dense(np.ones((3, 3), np.float32), device=dev),
            "hub40": hub,
            "hub40 padded": frdc.pad_frdc(hub, n + 13, n_groups=hub.n_groups + 11)}


def main_path_calls():
    """The timed launches at the main path's shapes on seeded inputs:
    ({name: call}, a maker of seeded sign words, the generator, a digest of
    the inputs)."""
    flickr, n_pad, bucket, items = serve_bucket()
    reddit = make_dataset("reddit", seed=SEED, scale=0.1)
    adj_f = flickr.adjacency("binary", dev)
    adj_r = reddit.adjacency("binary", dev)
    bin_b = bucket["bin"]
    gp = bin_b.grp_ptr.cpu().numpy()
    per = np.diff(gp)
    print(f"flickr 0/1: {adj_f.n_groups} groups; reddit x0.1 0/1: "
          f"{adj_r.n_groups} groups; bucket {n_pad} rows, {int(gp[-1])} real "
          f"groups of {bin_b.n_groups}, {int((per > 32).sum())} tile-rows over "
          f"32 groups hold {int(per[per > 32].sum())}, largest {int(per.max())}",
          flush=True)

    rng = np.random.default_rng(SEED + 15)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def words(rows, nbits):
        return bitops.pack_bits(card(rng.integers(0, 2, (rows, nbits))))

    h_f, h_r, h_b = (words(adj_f.n_cols, HIDDEN), words(adj_r.n_cols, HIDDEN),
                     words(n_pad, HIDDEN))
    x = card(rng.standard_normal((n_pad, flickr.x.shape[1])).astype(np.float32))
    bn = (card(0.1 * rng.standard_normal((1, x.shape[1])).astype(np.float32)),
          card(rng.uniform(0.5, 2.0, (1, x.shape[1])).astype(np.float32)))
    w1 = BinTensor(words(HIDDEN, x.shape[1]), card(rng.uniform(
        0.5, 1.5, (HIDDEN, 1)).astype(np.float32)), x.shape[1])
    plan = {blk: bspmm_kernel._block_plan(blk, HIDDEN, True)
            for blk in ((32, 32), (32, None))}
    timed = {
        "bspmm_bits flickr F=64 counts s3": lambda: bk.bspmm_bits_cuda(adj_f, h_f, HIDDEN, False, S3),
        "bspmm_bits flickr F=64 counts s2": lambda: bk.bspmm_bits_cuda(adj_f, h_f, HIDDEN, False, S2),
        "bspmm_bits flickr F=64 binarize s3": lambda: bk.bspmm_bits_cuda(adj_f, h_f, HIDDEN, True, S3),
        "bspmm_bits flickr F=64 binarize s2": lambda: bk.bspmm_bits_cuda(adj_f, h_f, HIDDEN, True, S2),
        "bspmm_bits reddit-0.1 F=64 counts s3": lambda: bk.bspmm_bits_cuda(adj_r, h_r, HIDDEN, False, S3),
        "bspmm_bits_grid bucket (32, 32) counts s3": lambda: bk.bspmm_bits_grid_cuda(
            bin_b, h_b, HIDDEN, False, S3, plan[(32, 32)]),
        "bspmm_bits_grid bucket (32, None) counts s3": lambda: bk.bspmm_bits_grid_cuda(
            bin_b, h_b, HIDDEN, False, S3, plan[(32, None)]),
        "gcn_bin_l1 bucket 500->64": lambda: fused_layer.gcn_bin_l1(
            x, bn, w1, bin_b, **items["bin"]),
    }
    inputs = digest(h_f, h_r, h_b, x, bn[0], bn[1], w1.packed, w1.scale,
                    adj_f.tiles, adj_r.tiles, bin_b.tiles)
    return timed, words, rng, inputs


def main():
    t0 = time.perf_counter()
    build.build_all()
    ptxas_report()
    variants = build_variants()
    print(f"tree {ROOT}; build {time.perf_counter() - t0:.1f} s; variants "
          f"{sorted(variants)}", flush=True)

    timed, words, rng, inputs = main_path_calls()
    res, outputs = {}, {}
    for name, call in timed.items():
        outputs[name] = call()
        runs = [("", contextlib.nullcontext)]
        if name.startswith("gcn_bin_l1"):
            runs.append((" transform only", lambda: transform_only(build)))
        for label, libs in variants.items():
            if source_of(name) not in libs:
                continue
            runs.append((f" {label}", lambda libs=libs: swapped(libs)))
        for turn in range(2):
            for label, ctx in (runs if turn == 0 else runs[::-1]):
                with ctx():
                    res.setdefault(f"{name}{label} device ms", []).append(
                        round(device_ms(torch, call), 4))
                    res.setdefault(f"{name}{label} ms", []).append(
                        round(cuda_ms(torch, call), 4))
        print(json.dumps({k: v for k, v in res.items() if k.startswith(name)}),
              flush=True)

    # edge cases, outputs only
    for gname, adj in edge_cases(rng).items():
        for f in (7, 100, 160):
            xw = words(adj.n_cols, f)
            for binz in (False, True):
                for mode in (S3, S2):
                    tag = f"{gname} F={f} binarize={binz} {mode}"
                    outputs[f"bspmm_bits {tag}"] = bk.bspmm_bits_cuda(
                        adj, xw, f, binz, mode)
                    for blk in ((4, None), (8, 32), (32, 64)):
                        outputs[f"bspmm_bits_grid {blk} {tag}"] = \
                            bk.bspmm_bits_grid_cuda(adj, xw, f, binz, mode,
                                                    bk._block_plan(blk, f, True))
    torch.cuda.synchronize()
    print(json.dumps(res, indent=1), flush=True)

    host = json.loads(json.dumps({k: (list(v.shape), str(v.dtype), digest(v))
                                  for k, v in outputs.items()}))
    if "--save" in sys.argv:
        path = Path(sys.argv[sys.argv.index("--save") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"inputs": inputs, "outputs": host}))
        print(f"saved {len(host)} outputs to {path}")
    if "--compare" in sys.argv:
        path = Path(sys.argv[sys.argv.index("--compare") + 1])
        ref = json.loads(path.read_text())
        if ref["inputs"] != inputs:
            sys.exit(f"bits_step0: inputs differ from {path}'s")
        bad = [k for k, want in ref["outputs"].items()
               if host.get(k) != want]
        for k in bad:
            print(f"compare {k}: DIFFERS")
        if bad:
            sys.exit(f"bits_step0: {len(bad)} of {len(ref['outputs'])} outputs "
                     f"differ")
        print(f"compare: all {len(ref['outputs'])} outputs bit-equal")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
