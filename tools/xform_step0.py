#!/usr/bin/env python3
"""Where the fused layer's time goes between its transform and its
aggregation, and how ``bmm_xnor`` compares with a bf16 matmul: the
measurement behind the redesign of the two dense binary / fp products.

Run from the repository root on a machine with one NVIDIA GPU, on this
tree or on another one (``--tree``, e.g. an earlier commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists):

    python3 tools/xform_step0.py [--tree scratch_chip/parent]
        [--save scratch_chip/xform.pt | --compare scratch_chip/xform.pt]

1. each fused layer kind at the serve bucket of full Flickr (GCN "bin"
   serve session, 32 seeds, 2 hops): ``gcn_bin_l1`` 500 -> 64 (also
   without BN, to show the cost of its division),
   ``gcn_bbf_fbf`` on packed words 64 -> 7, ``branch_add`` 500 -> 64 and
   ``fc`` 64 -> 7, whole and transform-only (the wrapper's own launch with
   ``aggregate = 0``: the kernel returns after its transform phase; fc
   aggregates nothing, and on a tree where it is its own launch,
   ``fused_fc``, the patch does not reach it: its two readings are of the
   same launch), median CUDA-event ms and torch.profiler device ms, each
   measured twice in turns;
2. ``bmm_xnor`` in counts mode at the four (M, N, K) that the five forwards
   of ``chip_smoke.py`` launch, beside a bf16 ``torch.matmul`` of the
   unpacked +-1 operands;
3. the yardsticks of the transforms: fp32 ``torch.matmul(z, w_eff)`` (TF32
   off) for ``gcn_bin_l1``, bf16 ``torch.matmul`` of +-1 operands for the
   BBF kinds, at the bucket;
4. ptxas' registers of ``bmm.cu`` and ``fused_layer.cu``, and whether
   ptxas takes ``mma ... .b1 ... .xor.popc`` for sm_90a.

``--save`` writes every output of sections 1-2 on seeded N(0,1) inputs
(and a digest of the inputs) to a file; ``--compare`` reads such a file,
written by another tree, and fails unless every output is bit-equal.
"""
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
ROOT = Path(sys.argv[sys.argv.index("--tree") + 1]).resolve() \
    if "--tree" in sys.argv else HERE
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(1, str(HERE))

from repro_torch.core import bitops  # noqa: E402
from repro_torch.core.binarize import BinTensor  # noqa: E402
from repro_torch.graphs.datasets import make_dataset  # noqa: E402
from repro_torch.kernels import bmm_kernel, build, fused_layer  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.serve import GraphStore, session_core  # noqa: E402
from chip_smoke import cuda_ms, device_ms, transform_only  # noqa: E402

SEED = 0
HIDDEN = 64
dev = "cuda"
XOR_PROBE = r"""
#include <stdint.h>
__global__ void probe(const uint32_t* a, const uint32_t* b, int* c) {
  int d[4] = {0, 0, 0, 0};
  asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                 "r"(b[1]));
  for (int i = 0; i < 4; ++i) c[threadIdx.x * 4 + i] = d[i];
}
"""


def ptxas_report():
    nvcc = build.nvcc_path()
    csrc = ROOT / "src/repro_torch/csrc"
    for name in ("bmm", "fused_layer"):
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o",
                            "/dev/null", str(csrc / f"{name}.cu")],
                           capture_output=True, text=True)
        for line in (r.stdout + r.stderr).splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "xor_probe.cu"
        src.write_text(XOR_PROBE)
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                            "-c", "-o", str(Path(tmp) / "p.o"), str(src)],
                           capture_output=True, text=True)
        verdict = "accepted" if r.returncode == 0 else \
            "refused: " + " | ".join((r.stdout + r.stderr).strip().splitlines()[:3])
        print(f"mma m16n8k256 b1 .xor.popc for sm_90a: {verdict}")


def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def serve_bucket():
    """Full Flickr, and the FRDCs and fused work of the serve bucket of the
    first batch of a warmed GCN session (32 seeds, 2 hops): per adjacency
    kind the keyword a fused kind takes it by, the task list (``tasks``)
    or, on a tree from before the task walk, the item offsets
    (``item_ptr``)."""
    flickr = make_dataset("flickr", seed=SEED, scale=1.0)
    n_fl, f_fl = flickr.x.shape
    st = GraphStore(max_batch=32, khop=2, use_pallas=True, device=dev,
                    fused=True)
    st.register_graph("flickr", flickr)
    st.register_model("gcn", "gcn", gnn.init_gcn(SEED, f_fl, HIDDEN,
                                                 flickr.n_classes, dev))
    sess = st.session("flickr", "gcn")
    sess.warmup(np.random.default_rng(SEED), probes=16)
    seeds = np.random.default_rng(SEED + 2).integers(0, n_fl, size=(8, 32))
    staged = sess.prepare_batch(seeds[0]).groups[0].staged
    n_pad = staged.x_pad.shape[0]
    work = ("tasks", "n_part", "item_ptr")
    bucket = {k: session_core.frdc_rebuild(
        {f: v.to(dev) for f, v in a.items() if f not in work}, n_pad, n_pad)
        for k, a in staged.adjs.items()}
    items = {k: dict(tasks=fused_layer.PairItems(a["tasks"].to(dev),
                                                 a["n_part"]))
             if "tasks" in a else dict(item_ptr=a["item_ptr"].to(dev))
             for k, a in staged.adjs.items()}
    print(f"bucket {n_pad} rows; groups {bucket['bin'].n_groups} (bin), "
          f"{bucket['adj'].n_groups} (adj)", flush=True)
    return flickr, n_pad, bucket, items


def main():
    t0 = time.perf_counter()
    build.build_all()
    ptxas_report()
    print(f"tree {ROOT}; build {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    flickr, n_pad, bucket, items = serve_bucket()
    n_fl, f_fl = flickr.x.shape
    n_cls = flickr.n_classes
    bin_b, adj_b = bucket["bin"], bucket["adj"]

    rng = np.random.default_rng(SEED + 14)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def normal(*shape):
        return card(rng.standard_normal(shape).astype(np.float32))

    def words(rows, nbits):
        return bitops.pack_bits(card(rng.integers(0, 2, (rows, nbits))))

    def weights(n_out, n_in):
        return BinTensor(words(n_out, n_in), card(rng.uniform(
            0.5, 1.5, (n_out, 1)).astype(np.float32)), n_in)

    def bn(f):
        return (0.1 * normal(1, f),
                card(rng.uniform(0.5, 2.0, (1, f)).astype(np.float32)))

    x, bn_x = normal(n_pad, f_fl), bn(f_fl)
    x_h, bn_h = normal(n_pad, HIDDEN), bn(HIDDEN)
    h_w = words(n_pad, HIDDEN)
    w1, w1b, w2 = weights(HIDDEN, f_fl), weights(HIDDEN, f_fl), \
        weights(n_cls, HIDDEN)
    fl = fused_layer
    kinds = {
        "gcn_bin_l1 500->64": lambda: fl.gcn_bin_l1(
            x, bn_x, w1, bin_b, **items["bin"]),
        "gcn_bin_l1 500->64 without BN": lambda: fl.gcn_bin_l1(
            x, None, w1, bin_b, **items["bin"]),
        "gcn_bbf_fbf words 64->7": lambda: fl.gcn_bbf_fbf(
            h_w, None, w2, adj_b, **items["adj"]),
        "branch_add 500->64": lambda: fl.branch_add(
            x, bn_x, w1, w1b, adj_b, relu=True, **items["adj"]),
        "fc 64->7": lambda: fl.fc(x_h, bn_h, w2),
    }
    res, outputs = {}, {}
    for name, call in kinds.items():
        outputs[name] = call()
        for turn in range(2):
            order = ("whole", "transform", "transform", "whole") if turn == 0 \
                else ("transform", "whole", "whole", "transform")
            for i, part in enumerate(order):
                key = f"{name} {part}"
                if part == "transform":
                    with transform_only(build):
                        ms, dv = cuda_ms(torch, call), device_ms(torch, call)
                else:
                    ms, dv = cuda_ms(torch, call), device_ms(torch, call)
                res.setdefault(key + " ms", []).append(ms)
                res.setdefault(key + " device ms", []).append(dv)
        print(json.dumps({k: v for k, v in res.items() if k.startswith(name)}),
              flush=True)

    # yardsticks of the transforms at the bucket
    z = (x - bn_x[0]) / bn_x[1]
    w_eff = (bitops.unpack_pm1(w1.packed, w1.n) * w1.scale).T.contiguous()
    a_pm1 = (2 * card(rng.integers(0, 2, (n_pad, f_fl))) - 1).to(torch.bfloat16)
    b_pm1 = (2 * card(rng.integers(0, 2, (f_fl, HIDDEN))) - 1).to(torch.bfloat16)
    h_pm1 = (2 * card(rng.integers(0, 2, (n_pad, HIDDEN))) - 1).to(torch.bfloat16)
    c_pm1 = (2 * card(rng.integers(0, 2, (HIDDEN, n_cls))) - 1).to(torch.bfloat16)
    for turn in range(2):
        for key, fn in (("fp32 matmul(z, w_eff) 89252x500x64", lambda: z @ w_eff),
                        ("bf16 matmul 500->64", lambda: a_pm1 @ b_pm1),
                        ("bf16 matmul 64->7", lambda: h_pm1 @ c_pm1)):
            res.setdefault(key + " ms", []).append(cuda_ms(torch, fn))
            res.setdefault(key + " device ms", []).append(device_ms(torch, fn))

    # bmm_xnor at the forwards' shapes
    reddit_rows = 23296
    shapes = [(n_fl, HIDDEN, f_fl), (n_fl, n_cls, HIDDEN), (n_fl, HIDDEN, HIDDEN),
              (reddit_rows, 41, HIDDEN)]
    for m, n, k in shapes:
        a, b = words(m, k), words(n, k)
        ap = (2 * card(rng.integers(0, 2, (m, k))) - 1).to(torch.bfloat16)
        bp = (2 * card(rng.integers(0, 2, (k, n))) - 1).to(torch.bfloat16)
        tag = f"bmm_xnor M={m} N={n} K={k}"
        for mode in (False, True):
            outputs[f"{tag} binarize={mode}"] = bmm_kernel.bmm_xnor_cuda(
                a, b, k, mode)
        res[tag + " ms"] = [cuda_ms(torch, lambda: bmm_kernel.bmm_xnor_cuda(
            a, b, k))]
        res[tag + " device ms"] = [device_ms(
            torch, lambda: bmm_kernel.bmm_xnor_cuda(a, b, k))]
        res[f"bf16 matmul M={m} N={n} K={k} ms"] = [cuda_ms(
            torch, lambda: ap @ bp)]
        res[f"bf16 matmul M={m} N={n} K={k} device ms"] = [device_ms(
            torch, lambda: ap @ bp)]
    torch.cuda.synchronize()
    print(json.dumps(res, indent=1), flush=True)

    inputs = digest(x, bn_x[0], bn_x[1], x_h, h_w, w1.packed, w1.scale,
                    w1b.packed, w2.packed, w2.scale, bin_b.tiles, adj_b.tiles)
    host = {k: v.cpu() for k, v in outputs.items()}
    if "--save" in sys.argv:
        path = Path(sys.argv[sys.argv.index("--save") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        torch.save({"inputs": inputs, "outputs": host}, path)
        print(f"saved {len(host)} outputs to {path}")
    if "--compare" in sys.argv:
        path = Path(sys.argv[sys.argv.index("--compare") + 1])
        ref = torch.load(path)
        if ref["inputs"] != inputs:
            sys.exit(f"xform_step0: inputs differ from {path}'s")
        bad = []
        for key, want in ref["outputs"].items():
            got = host.get(key)
            same = got is not None and got.shape == want.shape and \
                bool(torch.equal(got, want))
            print(f"compare {key}: {'bit-equal' if same else 'DIFFERS'}")
            if not same:
                bad.append(key)
        if bad:
            sys.exit(f"xform_step0: {len(bad)} outputs differ: {bad}")
        print(f"compare: all {len(ref['outputs'])} outputs bit-equal")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
