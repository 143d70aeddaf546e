#!/usr/bin/env python3
"""Build variants of the bits FRDC kernels and compare their device time.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 tools/bits_variants.py``

Each variant rewrites a copy of ``csrc/walk.cuh`` or of a kernel source
under ``src/repro_torch/_build/bits_step0/`` and builds ``bspmm.cu``,
``bspmm_grid.cu`` (and ``fused_layer.cu`` where the walk changes), one nvcc
a source, all started together:

* ``edges``: the edge-driven candidate for a group's counts in place of the
  register transpose (``walk::bits_group``): a ballot over the 32
  neighbour nibbles gives the hit neighbours; per hit the warp broadcasts
  the neighbour's gathered words (``__shfl_sync`` from the lane that loaded
  them) and lane f adds +1 or -1 into the rows of its nibble. Its cost
  grows with the edges of a group; the transpose's does not;
* ``heavy1d=N`` / ``heavygrid=N``: the 1D / grid bits kernels' threshold
  of groups a warp walks alone (16, one chunk, shipped);
* ``minblocks=N``: ``__launch_bounds__(256, N)`` on both bits kernels
  (shipped: 4 at up to 2 words a pass, 2 above; N = 1 leaves the compiler
  free).

Each build is timed on the launches of ``tools/bits_step0.py`` (full
Flickr and Reddit x0.1 at F = 64, the serve bucket's grid at two blocks,
the fused ``gcn_bin_l1``): device ms from torch.profiler, twice, in turns
with the shipped build; every variant's output must equal the shipped
build's bit for bit (all of them compute the same integers). Nothing here
is part of the port.
"""
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from bits_step0 import (CSRC, build, compile_variants, device_ms,  # noqa: E402
                        main_path_calls, source_of, swapped)

BITS_GROUP = "template <int kW, bool kS2>\n__device__ __forceinline__ void bits_group("
BITS_GROUP_END = "// end bits_group"
EDGES = r'''template <int kW, bool kS2>
__device__ __forceinline__ void bits_group(uint32_t my_tile, int q,
                                           const uint32_t xk[kW], int nw,
                                           int lane, int acc[kTile][kW]) {
  // lane k = t * 4 + j: neighbour column j of tile t; its rows are the bits
  // of column j, (tile_t >> j) & 0x1111, compressed to 4 bits
  const uint32_t tile =
      (uint32_t)__shfl_sync(kFull, (int)my_tile, q * kGroup + (lane >> 2));
  const uint32_t nib = (tile >> (lane & 3)) & 0x1111u;
  const int rows = (int)((nib | (nib >> 3) | (nib >> 6) | (nib >> 9)) & 0xFu);
  unsigned hits = __ballot_sync(kFull, rows != 0);
  while (hits) {
    const int k = __ffs(hits) - 1;
    hits &= hits - 1;
    const int r = __shfl_sync(kFull, rows, k);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (j >= nw) break;
      const uint32_t w = __shfl_sync(kFull, xk[j], k);
      const int v = ((w >> lane) & 1u) ? 1 : -1;
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        if ((r >> i) & 1) acc[i][j] += v;
    }
  }
}
'''
MIN_BLOCKS = "__launch_bounds__(kThreads, walk::bits_min_blocks(kW))"
HEAVY = {"bspmm": "constexpr int kHeavy = walk::kChunk;",
         "bspmm_grid": "constexpr int kBitsHeavy = walk::kChunk;"}


def plans():
    walk = (CSRC / "walk.cuh").read_text()
    src = {s: (CSRC / f"{s}.cu").read_text() for s in ("bspmm", "bspmm_grid")}
    start = walk.index(BITS_GROUP)
    edges = walk[:start] + EDGES + walk[walk.index(BITS_GROUP_END, start):]
    out = {"shipped": (walk, ("bspmm", "bspmm_grid", "fused_layer"), {}),
           "edges": (edges, ("bspmm", "bspmm_grid", "fused_layer"), {})}
    for s, name in (("bspmm", "heavy1d"), ("bspmm_grid", "heavygrid")):
        for n in (32, 64):
            out[f"{name}={n}"] = (walk, (s,), {s: src[s].replace(
                HEAVY[s], HEAVY[s].replace("walk::kChunk", str(n)))})
    for n in (1, 3):
        out[f"minblocks={n}"] = (walk, ("bspmm", "bspmm_grid"), {
            s: src[s].replace(MIN_BLOCKS, f"__launch_bounds__(kThreads, {n})")
            for s in src})
    for name, (w, sources, edited) in out.items():
        for s, text in edited.items():
            assert text != src[s], f"{name}: {s} unchanged"
    return out


def main():
    libs = compile_variants(plans())
    timed, *_ = main_path_calls()
    res, bad = {}, []
    for name, call in timed.items():
        src = source_of(name)
        with swapped(libs["shipped"]):
            want = call()
        runs = [v for v in libs if v != "shipped" and src in libs[v]]
        for v in runs:
            with swapped(libs[v]):
                if not torch.equal(call(), want):
                    bad.append(f"{name} {v}")
        for turn in range(2):
            for v in ["shipped", *runs] if turn == 0 else [*runs, "shipped"]:
                with swapped(libs[v]):
                    res.setdefault(f"{name} {v} device ms", []).append(
                        round(device_ms(torch, call), 4))
        print(json.dumps({k: v for k, v in res.items() if k.startswith(name)}),
              flush=True)
    print(f"outputs equal to the shipped build: {'all' if not bad else bad}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
