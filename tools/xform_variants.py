#!/usr/bin/env python3
"""Build variants of the tiled dense products and compare their device
time: the other route of ``bmm_xnor`` at each shape, and other transform
tiles of the fused layer.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 tools/xform_variants.py``

Each variant rewrites constants of a source in a copy under
``src/repro_torch/_build/variants/`` and builds it with ``-Xptxas -v``
(registers and spills printed):

* ``csrc/bmm.cu``: the widest N the simt route takes (``kSimtMaxN``; 0
  sends every N to the tensor cores) and its column threads (``kSimtCT``;
  16 gives a 64-column simt tile, which then takes every N up to 64).
  ``bmm_xnor`` runs at the four (M, N, K) the forwards of ``chip_smoke.py``
  launch; outputs must equal the plain version's.
* ``csrc/fused_layer.cu``: the rows a thread of the BMM.FBB register tile
  holds (``kFbbRM``; a tile is 16 x kFbbRM rows by 64 columns) and the
  chunks of fp input the BMM.BBF quantize keeps in its ring
  (``kBbfStages``; one fewer are in flight). ``gcn_bin_l1`` (500 -> 64)
  and ``branch_add`` (500 -> 64, with and without BN) run at the serve
  bucket of full Flickr, whole and transform-only; every variant's outputs
  must equal the first one's.

* ``csrc/fused_layer.cu``'s fc launch (``fused_fc``): the rows a warp
  takes (``kFcRows``) and a register cap for 8 blocks a SM
  (``__launch_bounds__``). ``fused_layer.fc`` runs 64 -> 7 at
  rows 7h (shard 0 of the P = 4 plan, 24,508 rows, BN by the reciprocal)
  and 7d (the serve bucket, 89,252 rows, BN by the division) on N(0, 1)
  inputs; every variant's outputs must equal the first one's.

* ``csrc/fused_layer.cu``'s aggregating kinds (rows 7a-7c): the
  cooperative kernel asking the compiler for 1 or 3 resident blocks a SM
  (``__launch_bounds__``; the shipped build asks 2), and the two-launch
  form of each kind: the transform alone (``fused_layer.transform``, the
  kernel with ``aggregate = 0``), then ``csrc/fused_pair.cu`` with an
  empty halo matrix (``fused_layer.pair``, its task list built
  beforehand). ``gcn_bin_l1`` 500 -> 64, ``gcn_bbf_fbf`` on words 64 -> 7
  and ``branch_add`` 500 -> 64 at the serve bucket of full Flickr, whole
  and transform-only; the builds' outputs must equal the shipped one's,
  and whether the two-launch outputs do is printed.

Times are torch.profiler device ms (and CUDA-event ms for ``bmm_xnor``,
``fused_fc`` and the aggregating kinds), the variants in turns, twice.
``--only bmm|fused|fc|agg`` runs one section. Nothing here is part of the
port.
"""
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))
sys.path.insert(1, str(ROOT))

from repro_torch.core import bitops  # noqa: E402
from repro_torch.core.binarize import BinTensor  # noqa: E402
from repro_torch.kernels import bmm_kernel, build, fused_layer  # noqa: E402
from chip_smoke import cuda_ms, device_ms, transform_only  # noqa: E402
from xform_step0 import serve_bucket  # noqa: E402

dev = "cuda"
OUT = ROOT / "src" / "repro_torch" / "_build" / "variants"
CSRC = ROOT / "src" / "repro_torch" / "csrc"
# per source: name -> {constant pattern: replacement}; the first is shipped
SIMT_CT = r"constexpr int kSimtCT = \d+;"
SIMT_MAX = r"constexpr int kSimtMaxN = [^;]+;"
FBB_RM = r"constexpr int kFbbRM = \d+, kFbbRN = 4;"
STAGES = r"constexpr int kBbfStages = \d+;"
BMM_VARIANTS = {
    "shipped (simt at N <= 8, mma above)": {},
    "mma at every N": {SIMT_MAX: "constexpr int kSimtMaxN = 0;"},
    "simt at N <= 64 (64-column tile)": {
        SIMT_CT: "constexpr int kSimtCT = 16;"},
}
FUSED_VARIANTS = {
    "shipped (12 rows, 4 stages)": {},
    "8 rows": {FBB_RM: "constexpr int kFbbRM = 8, kFbbRN = 4;"},
    "2 stages": {STAGES: "constexpr int kBbfStages = 2;"},
}
FC_ROWS = r"constexpr int kFcRows = \d+;"
FC_BOUNDS = r"__launch_bounds__\(kFcThreads\)"
FC_VARIANTS = {
    "shipped (4 rows a warp)": {},
    "2 rows a warp": {FC_ROWS: "constexpr int kFcRows = 2;"},
    "8 rows a warp": {FC_ROWS: "constexpr int kFcRows = 8;"},
    "8 blocks a SM (32 registers)": {
        FC_BOUNDS: "__launch_bounds__(kFcThreads, 8)"},
}
AGG_BOUNDS = r"__launch_bounds__\(kThreads, 2\)\n    fused_layer_kernel"
AGG_VARIANTS = {
    "shipped (2 blocks a SM)": {},
    "1 block a SM": {
        AGG_BOUNDS: "__launch_bounds__(kThreads, 1)\n    fused_layer_kernel"},
    "3 blocks a SM": {
        AGG_BOUNDS: "__launch_bounds__(kThreads, 3)\n    fused_layer_kernel"},
}
TWO_LAUNCHES = "two launches (transform, then fused_pair)"
# fc's rows at 7h (shard 0, BN by the reciprocal) and 7d (the serve bucket)
FC_SHAPES = (("7h", 24508, True), ("7d", 89252, False))
# bmm_xnor's (M, N, K) in the five forwards of chip_smoke.py
BMM_SHAPES = ((89250, 64, 500), (89250, 7, 64), (89250, 64, 64),
              (23296, 41, 64))


def make(source: str, name: str, subs: dict) -> ctypes.CDLL:
    """Build ``csrc/<source>.cu`` with ``subs`` applied and load it."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / f"{source}.cu").read_text()
    for pattern, text in subs.items():
        src, n = re.subn(pattern, text, src)
        if n != 1:
            sys.exit(f"xform_variants: csrc/{source}.cu lacks {pattern!r}")
    tag = re.sub(r"\W+", "_", name).strip("_")
    cu = OUT / f"{source}_{tag}.cu"
    cu.write_text(src)
    so = cu.with_suffix(".so")
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v",
                        "-I", str(CSRC), "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        sys.exit(f"xform_variants: {source} {name} failed to build:\n{r.stderr}")
    for line in (r.stdout + r.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {source} {name}: {line.strip()}")
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in build.SIGNATURES[source].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def in_turns(variants):
    """The variants' names, forward then backward (so the shipped build,
    first, is also the one left loaded)."""
    return list(variants) + list(reversed(variants))


def bmm_routes(rng) -> dict:
    libs = {name: make("bmm", name, subs) for name, subs in BMM_VARIANTS.items()}

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    cases = []
    for m, n, k in BMM_SHAPES:
        a = bitops.pack_bits(card(rng.integers(0, 2, (m, k))))
        b = bitops.pack_bits(card(rng.integers(0, 2, (n, k))))
        cases.append((f"{m}x{n}x{k}", a, b, k, [
            bmm_kernel.bmm_xnor_plain(a, b, k, binz) for binz in (False, True)]))
    res = {}
    for name in in_turns(BMM_VARIANTS):
        build._LIBS["bmm"] = libs[name]
        row = res.setdefault(name, {})
        for shape, a, b, k, want in cases:
            for binz in (False, True):
                if not torch.equal(bmm_kernel.bmm_xnor_cuda(a, b, k, binz),
                                   want[binz]):
                    sys.exit(f"xform_variants: bmm {name} differs from the "
                             f"plain version at {shape} binarize={binz}")
            n, wk = b.shape
            row[f"{shape} attributes"] = bmm_kernel.attributes(n, wk)
            for unit, timer in (("ms", cuda_ms), ("device ms", device_ms)):
                row.setdefault(f"{shape} {unit}", []).append(
                    timer(torch, lambda: bmm_kernel.bmm_xnor_cuda(a, b, k)))
    return res


def fused_tiles(rng) -> dict:
    libs = {name: make("fused_layer", name, subs)
            for name, subs in FUSED_VARIANTS.items()}
    flickr, n_pad, bucket, items = serve_bucket()
    f = flickr.x.shape[1]

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def weights():
        return BinTensor(bitops.pack_bits(card(rng.integers(0, 2, (64, f)))),
                         card(rng.uniform(0.5, 1.5, (64, 1)).astype(np.float32)),
                         f)
    x = card(rng.standard_normal((n_pad, f)).astype(np.float32))
    bn = (card(0.1 * rng.standard_normal((1, f)).astype(np.float32)),
          card(rng.uniform(0.5, 2.0, (1, f)).astype(np.float32)))
    w1, w2 = weights(), weights()
    calls = {
        "gcn_bin_l1": lambda: fused_layer.gcn_bin_l1(
            x, bn, w1, bucket["bin"], **items["bin"]),
        "gcn_bin_l1 without BN": lambda: fused_layer.gcn_bin_l1(
            x, None, w1, bucket["bin"], **items["bin"]),
        "branch_add": lambda: fused_layer.branch_add(
            x, bn, w1, w2, bucket["adj"], **items["adj"]),
        "branch_add without BN": lambda: fused_layer.branch_add(
            x, None, w1, w2, bucket["adj"], **items["adj"]),
    }
    res, first = {}, None
    order = in_turns(FUSED_VARIANTS)
    for name in order:
        build._LIBS["fused_layer"] = libs[name]
        outs = [call() for call in calls.values()]
        if first is None:
            first = outs
        elif not all(torch.equal(a, b) for a, b in zip(outs, first)):
            sys.exit(f"xform_variants: {name}'s outputs differ from {order[0]}'s")
        row = res.setdefault(name, {})
        row["attributes fbb"] = fused_layer.attributes(f, fbb=True)
        row["attributes bbf"] = fused_layer.attributes(f, self_branch=True)
        for cname, call in calls.items():
            row.setdefault(f"{cname} whole device ms", []).append(
                device_ms(torch, call))
            with transform_only(build):
                row.setdefault(f"{cname} transform device ms", []).append(
                    device_ms(torch, call))
    return res


def fc_variants(rng) -> dict:
    libs = {name: make("fused_layer", name, subs)
            for name, subs in FC_VARIANTS.items()}

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    h, c = 64, 7
    w = BinTensor(bitops.pack_bits(card(rng.integers(0, 2, (c, h)))),
                  card(rng.uniform(0.5, 1.5, (c, 1)).astype(np.float32)), h)
    bn = (card(0.1 * rng.standard_normal((1, h)).astype(np.float32)),
          card(rng.uniform(0.5, 2.0, (1, h)).astype(np.float32)))
    calls = {}
    for tag, rows, rcp in FC_SHAPES:
        x = card(rng.standard_normal((rows, h)).astype(np.float32))
        calls[f"{tag} {rows}x{h}->{c}"] = (
            lambda x=x, rcp=rcp: fused_layer.fc(x, bn, w, bn_rcp=rcp))
    res, first = {}, None
    order = in_turns(FC_VARIANTS)
    for name in order:
        build._LIBS["fused_layer"] = libs[name]
        outs = [call() for call in calls.values()]
        if first is None:
            first = outs
        elif not all(torch.equal(a, b) for a, b in zip(outs, first)):
            sys.exit(f"xform_variants: fc {name}'s outputs differ from "
                     f"{order[0]}'s")
        row = res.setdefault(name, {})
        row["attributes"] = fused_layer.fc_attributes(h)
        for cname, call in calls.items():
            for unit, timer in (("ms", cuda_ms), ("device ms", device_ms)):
                row.setdefault(f"{cname} {unit}", []).append(
                    timer(torch, call))
    return res


def empty_halo(adj):
    """A halo matrix over the tile-rows of ``adj`` with no group."""
    none = torch.zeros((0, 8), dtype=torch.int32, device=adj.device)
    return adj._replace(tiles=none, col_idx=none.clone(),
                        group_row=torch.zeros(0, dtype=torch.int32,
                                              device=adj.device),
                        group_first=torch.zeros(0, dtype=torch.int32,
                                                device=adj.device),
                        grp_ptr=torch.zeros_like(adj.grp_ptr), n_cols=0,
                        nnz=0, row_scale=None, col_scale=None)


def agg_variants(rng) -> dict:
    libs = {name: make("fused_layer", name, subs)
            for name, subs in AGG_VARIANTS.items()}
    flickr, n_pad, bucket, items = serve_bucket()
    f = flickr.x.shape[1]
    fl = fused_layer

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def words(rows, nbits):
        return bitops.pack_bits(card(rng.integers(0, 2, (rows, nbits))))

    def weights(n_out, n_in):
        return BinTensor(words(n_out, n_in), card(rng.uniform(
            0.5, 1.5, (n_out, 1)).astype(np.float32)), n_in)
    x = card(rng.standard_normal((n_pad, f)).astype(np.float32))
    bn = (card(0.1 * rng.standard_normal((1, f)).astype(np.float32)),
          card(rng.uniform(0.5, 2.0, (1, f)).astype(np.float32)))
    h_w = words(n_pad, 64)
    w1, w1b, w2 = weights(64, f), weights(64, f), weights(flickr.n_classes, 64)
    bin_b, adj_b = bucket["bin"], bucket["adj"]
    halo = {k: empty_halo(m) for k, m in bucket.items()}
    pairs = {k: fl.pair_items(m, halo[k]) for k, m in bucket.items()}
    # the pair kernel's rem: a few rows that no empty halo group reads
    rem_f = torch.zeros((4, 64), device=dev)
    rem_w = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    rem_c = torch.zeros((4, flickr.n_classes), device=dev)
    calls = {   # name: (one launch, two launches)
        "7a gcn_bin_l1 500->64": (
            lambda: fl.gcn_bin_l1(x, bn, w1, bin_b, **items["bin"]),
            lambda: fl.pair(fl.transform(x, bn, w1, fbb=True), None, rem_w,
                            bin_b, halo["bin"], pairs["bin"], n_out=64)),
        "7b gcn_bbf_fbf words 64->7": (
            lambda: fl.gcn_bbf_fbf(h_w, None, w2, adj_b, **items["adj"]),
            lambda: fl.pair(fl.transform(h_w, None, w2), None, rem_c, adj_b,
                            halo["adj"], pairs["adj"])),
        "7c branch_add 500->64": (
            lambda: fl.branch_add(x, bn, w1, w1b, adj_b, relu=True,
                                  **items["adj"]),
            lambda: fl.pair(*fl.transform(x, bn, w1b, w_self=w1),
                            rem_f, adj_b, halo["adj"],
                            pairs["adj"], relu=True)),
    }
    res, first = {}, None
    order = in_turns(AGG_VARIANTS)
    for name in order:
        build._LIBS["fused_layer"] = libs[name]
        outs = [one() for one, _ in calls.values()]
        if first is None:
            first = outs
        elif not all(torch.equal(a, b) for a, b in zip(outs, first)):
            sys.exit(f"xform_variants: {name}'s outputs differ from {order[0]}'s")
        row = res.setdefault(name, {})
        row["attributes fbb"] = fl.attributes(f, fbb=True)
        row["attributes bbf self"] = fl.attributes(f, self_branch=True)
        row["attributes bbf 64"] = fl.attributes(64)
        for cname, (one, _) in calls.items():
            for unit, timer in (("ms", cuda_ms), ("device ms", device_ms)):
                row.setdefault(f"{cname} whole {unit}", []).append(
                    timer(torch, one))
            with transform_only(build):
                row.setdefault(f"{cname} transform device ms", []).append(
                    device_ms(torch, one))
        if name == order[0]:   # the shipped build's turns
            two = res.setdefault(TWO_LAUNCHES, {})
            for (cname, (_, pair2)), want in zip(calls.items(), first):
                two[f"{cname} bit-equal to one launch"] = bool(
                    torch.equal(pair2(), want))
                for unit, timer in (("ms", cuda_ms), ("device ms", device_ms)):
                    two.setdefault(f"{cname} {unit}", []).append(
                        timer(torch, pair2))
    return res


def main():
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv \
        else None
    build.build_all(["bmm", "fused_layer", "fused_pair"])
    rng = np.random.default_rng(14)
    if only in (None, "bmm"):
        print("bmm_xnor routes: " + json.dumps(bmm_routes(rng), indent=1),
              flush=True)
    if only in (None, "fused"):
        print("fused transform tiles: " + json.dumps(fused_tiles(rng),
                                                     indent=1), flush=True)
    if only in (None, "fc"):
        print("fc launch: " + json.dumps(fc_variants(rng), indent=1))
    if only in (None, "agg"):
        print("aggregating kinds: " + json.dumps(agg_variants(rng), indent=1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
