#!/usr/bin/env python3
"""Variant builds of the sharded pair kernel (``csrc/fused_pair.cu``) timed
in one process at shard 0 of full Flickr cut into P = 4: the measurement
behind its launch bounds, its grid, its combine and its loads.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/pair_variants.py

Each variant is the shipped source (``csrc/fused_pair.cu``, and the task
walk it includes, ``csrc/tasks.cuh``) with a text change, built by nvcc
beside the shipped library and swapped in through ``build._LIBS``, so that
the normal wrapper (``fused_layer.pair``) launches it:

* ``fp min blocks 4``: the fp kernel asks the compiler for 4 resident
  blocks a SM (``__launch_bounds__``), capping its registers at 64;
* ``bits min blocks 2``: the counts kernel at 2 blocks a SM at every pass
  width (the shipped ``walk::bits_min_blocks`` asks 4 up to 2 words);
* ``warps loop over tasks``: a grid of the resident blocks, each warp
  taking tasks warp, warp + the launch's warps, ..., not a block per 8
  tasks;
* ``combine 8 items at once``: a heavy fp row's combine loads 8 items'
  partial sums before adding them in item order, not one item's;
* ``halo index loads early``: a light fp row sends its halo walk's first
  tiles and tile-columns to L2 before its intra walk.

For each of the four pair forms of ``tools/pair_step0.py`` (the pair launch
alone on the step's transform) it prints torch.profiler device ms and
CUDA-event ms, the shipped build first and last, each variant's
registers and resident blocks a SM, and holds every output bit-equal to
the shipped build's (no variant changes the arithmetic).
"""
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(1, str(HERE))
sys.path.insert(2, str(HERE / "tools"))

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bspmm_kernel import fp_layout  # noqa: E402
from repro_torch.graphs.datasets import make_dataset  # noqa: E402
from chip_smoke import cuda_ms, device_ms  # noqa: E402
import pair_step0  # noqa: E402

OUT = build.BUILD_DIR / "pair_variants"
FP_BOUNDS = "__launch_bounds__(kThreads)\n    fused_pair_fp_kernel"
BITS_BOUNDS = "__launch_bounds__(kThreads, walk::bits_min_blocks(kW))"
TASK = ("  const long long t = (long long)blockIdx.x * kWarps + warp;\n"
        "  if (t >= a.n_tasks) return;\n")
TASK_LOOP = ("  for (long long t = (long long)blockIdx.x * kWarps + warp; "
             "t < a.n_tasks;\n       t += (long long)gridDim.x * kWarps) {\n")
FP_TASK = "                                          s_hits[warp]);\n}"
BITS_TASK = "                                  lane);\n}"
GRID = "  const unsigned blocks = (unsigned)((p.n_tasks + kWarps - 1) / kWarps);\n"
GRID_RESIDENT = (
    "  unsigned blocks = (unsigned)((p.n_tasks + kWarps - 1) / kWarps);\n"
    "  int resident = 0;\n"
    "  if (p.fbb)\n"
    "    walk::with_bits_pass((p.ho + 31) / 32, p.s2, [&](auto w, auto s2) {\n"
    "      return launch::resident_blocks(fused_pair_bits_kernel<decltype(w)::value,\n"
    "          decltype(s2)::value>, kThreads, 0, &resident);});\n"
    "  else\n"
    "    walk::with_fp_layout(p.fp_sub, p.fp_cols, p.fp_vec, [&](auto a, auto b, auto c) {\n"
    "      return launch::resident_blocks(fused_pair_fp_kernel<decltype(a)::value,\n"
    "          decltype(b)::value, decltype(c)::value>, kThreads, 0, &resident);});\n"
    "  if (resident > 0 && blocks > (unsigned)resident) blocks = resident;\n")
COMBINE = """    for (int it = 0; it < n_i; ++it) {
      const float* q = first + (size_t)it * slot + col;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        acc[i] = __fadd_rn(acc[i], __ldcg(q + (size_t)i * w.ho));
    }
    for (int it = n_i; it < n_all; ++it) {
      const float* q = first + (size_t)it * slot + col;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        hacc[i] = __fadd_rn(hacc[i], __ldcg(q + (size_t)i * w.ho));
    }
"""
COMBINE_8 = """    for (int it0 = 0; it0 < n_all; it0 += 8) {
      float v[8][kTile];
#pragma unroll
      for (int b = 0; b < 8; ++b)
#pragma unroll
        for (int i = 0; i < kTile; ++i)
          v[b][i] = it0 + b < n_all
              ? __ldcg(first + (size_t)(it0 + b) * slot + (size_t)i * w.ho + col)
              : 0.f;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        if (it0 + b >= n_all) break;
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
          if (it0 + b < n_i) acc[i] = __fadd_rn(acc[i], v[b][i]);
          else hacc[i] = __fadd_rn(hacc[i], v[b][i]);
        }
      }
    }
"""
HALO_RANGE = ("    h1 = w.h.grp_ptr[tr + 1];\n  }\n"
              "  for (int c0 = 0;")
HALO_EARLY = (
    "    h1 = w.h.grp_ptr[tr + 1];\n"
    "    if (lane / walk::kGroup < h1 - h0) {\n"
    "      asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(w.h.tiles + (size_t)h0 * walk::kGroup + lane));\n"
    "      asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(w.h.col_idx + (size_t)h0 * walk::kGroup + lane));\n"
    "    }\n  }\n"
    "  for (int c0 = 0;")
PAIR, TASKS = "fused_pair.cu", "tasks.cuh"
# name -> [(file, old text, new text)]
VARIANTS = {
    "fp min blocks 4": [(PAIR, FP_BOUNDS, FP_BOUNDS.replace(
        "(kThreads)", "(kThreads, 4)"))],
    "bits min blocks 2": [(PAIR, BITS_BOUNDS,
                           "__launch_bounds__(kThreads, 2)")],
    "warps loop over tasks": [(PAIR, TASK, TASK_LOOP),
                              (PAIR, FP_TASK, FP_TASK + "\n}"),
                              (PAIR, BITS_TASK, BITS_TASK + "\n}"),
                              (PAIR, GRID, GRID_RESIDENT)],
    "combine 8 items at once": [(TASKS, COMBINE, COMBINE_8)],
    "halo index loads early": [(TASKS, HALO_RANGE, HALO_EARLY)],
}


def build_variants():
    """Start one nvcc a variant (in parallel); returns name -> library.
    A variant's edited files go to a directory of its own: the source's
    quoted includes find an edited header there before ``csrc/``."""
    procs = {}
    for name, edits in VARIANTS.items():
        texts = {}
        for file, old, new in edits:
            text = texts.get(file) or (build.CSRC / file).read_text()
            if old not in text:
                raise SystemExit(f"pair_variants: {name}: {file} text not "
                                 f"found")
            texts[file] = text.replace(old, new)
        texts.setdefault(PAIR, (build.CSRC / PAIR).read_text())
        where = OUT / name.replace(" ", "_")
        where.mkdir(parents=True, exist_ok=True)
        for file, text in texts.items():
            (where / file).write_text(text)
        so = where / "fused_pair.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(so), str(where / PAIR)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"pair_variants: nvcc failed for {name}:\n{log}")
        libs[name] = build._load("fused_pair", so)
    return libs


def attrs(lib, args):
    """Registers and resident blocks a SM of the instance a form runs."""
    out = (ctypes.c_int * 4)()
    y, rem = args[0], args[2]
    if y.dtype == torch.int32:
        build.check(lib.fused_pair_bits_attrs(y.shape[1], 0, out), "attrs")
    else:
        lay = fp_layout(y.shape[1], y.shape[1], y.data_ptr() | rem.data_ptr())
        build.check(lib.fused_pair_fp_attrs(lay.sub, lay.cols, int(lay.vec),
                                            out), "attrs")
    return {"registers": out[0], "blocks_per_sm": out[2]}


def main():
    t0 = time.perf_counter()
    build.build_all()
    libs = {"shipped": build.library("fused_pair"), **build_variants()}
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    flickr = make_dataset("flickr", seed=pair_step0.SEED, scale=1.0)
    sess = pair_step0.sessions(flickr)
    forms = pair_step0.step_calls(sess)
    order = list(libs) + ["shipped"]
    res = {}
    for form, (_, _, pair, _) in forms.items():
        build._LIBS["fused_pair"] = libs["shipped"]
        want = pair()
        row = {}
        for turn, name in enumerate(order):
            build._LIBS["fused_pair"] = libs[name]
            got = pair()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise SystemExit(f"pair_variants: {name} differs on {form}")
            key = name if turn < len(libs) else "shipped (again)"
            row[key] = {"device_ms": device_ms(torch, pair),
                        "ms": cuda_ms(torch, pair),
                        **attrs(libs[name], pair.args)}
        res[form] = row
        print(f"{form}: " + json.dumps(row), flush=True)
    build._LIBS["fused_pair"] = libs["shipped"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
