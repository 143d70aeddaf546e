#!/usr/bin/env python3
"""The sharded executors' fused step at shard 0 of full Flickr cut into
P = 4, timed and held bit for bit across two trees: the measurement behind
the redesign of its pair body (a one-launch cooperative kernel that
recomputed the transform, then the transform launch and
``csrc/fused_pair.cu``).

Run from the repository root on a machine with one NVIDIA GPU, on this
tree or on another one (``--tree``, e.g. an earlier commit unpacked with
``git archive`` into a directory that ``.gitignore`` lists):

    python3 tools/pair_step0.py [--tree scratch_chip/parent]
        [--save scratch_chip/pair.json | --compare scratch_chip/pair.json]

1. the four pair forms at shard 0's shapes (24,508 rows, halo 55,716): GCN
   "bin" layer 1 (500 -> 64 sign words over the 0/1 pair), GCN "full"
   layer 1 (500 -> 64, scaled, ReLU), GCN "bin" layer 2 (words 64 -> 7)
   and SAGE layer 1 (self + mean, 500 -> 64, ReLU), on seeded inputs,
   and SAINT's fc 64 -> 7 with BN by the reciprocal (``fc+rcp``, one
   launch, on N(0, 1) rows; the step only):
   the step (each kind's entry point with its halo) in CUDA-event ms and
   torch.profiler device ms, its transform alone (``fused_layer.transform``)
   and the pair launch alone on the transform's output, with its bound
   (bytes of both matrices' groups, tasks, the gathered rows of y and rem,
   the scales, ys and the output);
2. the distributed pass of every fused sharded way (GCN "bin", GCN "full",
   SAGE, SAINT; ``ShardedGraphSession(executor="host")``, seeded weights)
   in host ms (median of 5), with its launches, halo bytes a pass and
   ``compile_count``;
3. ptxas' registers and spills of ``fused_layer.cu`` and
   ``fused_pair.cu``.

``--save`` writes the SHA-256 of every output of sections 1-2 (each step,
and each pass's logits; the inputs are made from a fixed seed in a fixed
order on either tree) and the launches, halo bytes and program counts of
section 2 to a JSON file; ``--compare`` reads such a file, written by
another tree, and fails unless every output is bit-equal and the counts
are the same.
"""
import hashlib
import json
import statistics
import subprocess
import sys
import time
from functools import partial
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
from repro_torch.kernels import build, fused_layer, ops  # noqa: E402
from repro_torch.models import gnn  # noqa: E402
from repro_torch.serve import GraphStore, session_core  # noqa: E402
from repro_torch.serve.sharded import ShardedGraphSession, \
    ShardPlanner  # noqa: E402
from chip_smoke import FP32_OPS_PER_S, INT8_TC_OPS_PER_S, bound, cuda_ms, \
    device_ms, group_bytes  # noqa: E402

SEED = 0
HIDDEN = 64
SHARDS = 4
dev = "cuda"
fl = fused_layer
# name -> (family, scheme)
WAYS = {"gcn_bin/fused": ("gcn", "bin"), "gcn_full/fused": ("gcn", "full"),
        "sage/fused": ("sage", "fixed"), "saint/fused": ("saint", "fixed")}


def ptxas_report():
    nvcc = build.nvcc_path()
    for name in ("fused_layer", "fused_pair"):
        src = ROOT / f"src/repro_torch/csrc/{name}.cu"
        r = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                            "-std=c++17", "-O3", "-Xptxas", "-v", "-c", "-o",
                            "/dev/null", str(src)], capture_output=True,
                           text=True)
        for line in (r.stdout + r.stderr).splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")


def digest(t):
    h = hashlib.sha256()
    h.update(str(tuple(t.shape)).encode() + str(t.dtype).encode())
    h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def host_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def sessions(flickr):
    n_feat, n_cls = flickr.x.shape[1], flickr.n_classes
    params = {"gcn": gnn.init_gcn(SEED, n_feat, HIDDEN, n_cls, dev),
              "sage": gnn.init_sage(SEED, n_feat, HIDDEN, n_cls, dev),
              "saint": gnn.init_saint(SEED, n_feat, HIDDEN, n_cls, dev)}
    store = GraphStore(max_batch=32, khop=2, use_pallas=True, device=dev)
    store.register_graph("flickr", flickr)
    for fam, p in params.items():
        store.register_model(fam, fam, p)
    graph = store.graphs["flickr"]
    plans = {}
    out = {}
    for name, (fam, scheme) in WAYS.items():
        if fam not in plans:
            plans[fam] = ShardPlanner(SHARDS).plan(flickr, fam)
        variants = (session_core.GCN_SCHEME_VARIANTS[scheme] if fam == "gcn"
                    else session_core.FIXED_VARIANTS)
        plan = session_core.SessionPlan(fam, scheme, layer_variants=variants,
                                        fused=True)
        sess = ShardedGraphSession(
            graph, store.models[fam], plan,
            session_core.quantize_family(fam, params[fam]), plans[fam],
            khop=2, max_batch=32, use_pallas=True, device=dev)
        sess.sync()
        out[name] = sess
    return out


def step_calls(sess):
    """name -> (step, transform alone, pair alone or None, pair bound or
    None) of the four pair forms and of fc+rcp (step only) at shard 0,
    seeded inputs."""
    rng = np.random.default_rng(SEED + 21)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def ints(shape, lo=-3, hi=4):
        return card(rng.integers(lo, hi, shape).astype(np.float32))

    def words(rows, nbits):
        return bitops.pack_bits(card(rng.integers(0, 2, (rows, nbits))))

    def weights(n_out, n_in):
        return BinTensor(words(n_out, n_in), card(rng.choice(
            [0.25, 0.5, 1.0], (n_out, 1)).astype(np.float32)), n_in)

    def bn_of(f):
        return (ints((1, f), -1, 2),
                card(rng.choice([1.0, 2.0], (1, f)).astype(np.float32)))

    def shard0(name, kind):
        ex = sess[name].layer_executor
        a, h, it = ex._intra[kind][0], ex._halo[kind][0], ex._items[kind][0]
        return a, h, it, dict(pair_items=it)

    def pair_bound(a, h, it, y, ys, rem, ho, words_):
        nbytes = (group_bytes(a) + group_bytes(h) + 8 * it.tasks.shape[0]
                  + y.element_size() * y.shape[1]
                  * (y.shape[0] + rem.shape[0] + a.n_rows))
        for scale in (a.row_scale, a.col_scale, h.col_scale):
            nbytes += 0 if scale is None else 4 * scale.numel()
        if ys is not None:
            nbytes += 4 * ys.numel()
        return bound(nbytes, [(2 * (a.nnz + h.nnz) * ho, INT8_TC_OPS_PER_S
                               if words_ else FP32_OPS_PER_S)])

    n_feat = sess["gcn_bin/fused"].graph.data.x.shape[1]
    n_cls = sess["gcn_bin/fused"].graph.data.n_classes
    # name -> (step, transform alone, pair's rows besides y, its keywords,
    # words?); every call binds its inputs now (partial), as the names are
    # rebound from one form to the next
    forms = {}
    # 7e: GCN "bin" layer 1
    a, h, it, kw = shard0("gcn_bin/fused", "bin")
    x, bn, w = ints((a.n_rows, n_feat)), bn_of(n_feat), weights(HIDDEN, n_feat)
    rem = words(h.n_cols, HIDDEN)
    forms["gcn_bin_l1+halo"] = (
        partial(fl.gcn_bin_l1, x, bn, w, a, halo=h, rem=rem, bn_rcp=True,
                **kw),
        partial(fl.transform, x, bn, w, fbb=True, bn_rcp=True),
        (rem, a, h, it), dict(n_out=HIDDEN), True)
    # 7f: GCN "full" layer 1
    a, h, it, kw = shard0("gcn_full/fused", "adj")
    x, bn, w = ints((a.n_rows, n_feat)), bn_of(n_feat), weights(HIDDEN, n_feat)
    rem = ints((h.n_cols, HIDDEN))
    forms["gcn_bbf_fbf+halo"] = (
        partial(fl.gcn_bbf_fbf, x, bn, w, a, True, halo=h, rem=rem,
                bn_rcp=True, **kw),
        partial(fl.transform, x, bn, w, bn_rcp=True),
        (rem, a, h, it), dict(relu=True), False)
    # GCN "bin" layer 2: words 64 -> 7
    a, h, it, kw = shard0("gcn_bin/fused", "adj")
    hw, w = words(a.n_rows, HIDDEN), weights(n_cls, HIDDEN)
    rem = ints((h.n_cols, n_cls))
    forms["gcn_bbf_fbf+halo words"] = (
        partial(fl.gcn_bbf_fbf, hw, None, w, a, halo=h, rem=rem, **kw),
        partial(fl.transform, hw, None, w), (rem, a, h, it), {}, False)
    # 7g: SAGE layer 1
    a, h, it, kw = shard0("sage/fused", "mean")
    x, bn = ints((a.n_rows, n_feat)), bn_of(n_feat)
    ws, wa = weights(HIDDEN, n_feat), weights(HIDDEN, n_feat)
    rem = ints((h.n_cols, HIDDEN))
    forms["branch_add+halo"] = (
        partial(fl.branch_add, x, bn, ws, wa, a, True, halo=h, rem=rem,
                bn_rcp=True, **kw),
        partial(fl.transform, x, bn, wa, bn_rcp=True, w_self=ws),
        (rem, a, h, it), dict(relu=True), False)
    # 7h: SAINT's fc 64 -> 7 with BN by the reciprocal, one launch and no
    # pair, on N(0, 1) rows (so the order of its row scale's sum shows)
    xf = card(rng.standard_normal((a.n_rows, HIDDEN)).astype(np.float32))
    bnf = (card((0.1 * rng.standard_normal((1, HIDDEN))).astype(np.float32)),
           card(rng.uniform(0.5, 2.0, (1, HIDDEN)).astype(np.float32)))
    wf = BinTensor(words(n_cls, HIDDEN), card(rng.uniform(
        0.5, 1.5, (n_cls, 1)).astype(np.float32)), HIDDEN)
    forms["fc+rcp"] = (partial(fl.fc, xf, bnf, wf, bn_rcp=True), None, None,
                       {}, False)
    out = {}
    for name, (step, xform, rest, pkw, words_) in forms.items():
        pair = bnd = None
        if rest is not None:
            y = xform()
            y, ys = y if isinstance(y, tuple) else (y, None)
            pair = partial(fl.pair, y, ys, *rest, **pkw)
            rem_, a_, h_, it_ = rest
            bnd = pair_bound(a_, h_, it_, y, ys, rem_,
                             pkw.get("n_out") or y.shape[1], words_)
        out[name] = (step, xform, pair, bnd)
    return out


def main():
    t0 = time.perf_counter()
    build.build_all()
    ptxas_report()
    print(f"tree {ROOT}; build "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    flickr = make_dataset("flickr", seed=SEED, scale=1.0)
    sess = sessions(flickr)
    digests, counts, res = {}, {}, {}

    # 1. the pair forms at shard 0
    for name, (step, xform, pair, bnd) in step_calls(sess).items():
        digests[f"step {name}"] = digest(step())
        row = {}
        for turn in range(2):
            row.setdefault("step_ms", []).append(cuda_ms(torch, step))
            row.setdefault("step_device_ms", []).append(device_ms(torch, step))
            if pair is not None:
                row.setdefault("transform_ms", []).append(cuda_ms(torch, xform))
                row.setdefault("pair_ms", []).append(cuda_ms(torch, pair))
                row.setdefault("pair_device_ms", []).append(
                    device_ms(torch, pair))
        if pair is not None:
            row["pair_bound_ms"], row["pair_bound_by"] = bnd
            it = pair.args[5]
            row["tasks"], row["multi_item_tasks"] = (it.tasks.shape[0],
                                                     it.n_part)
        res[name] = row
        print(f"{name}: " + json.dumps(row), flush=True)

    # 2. the distributed passes
    for name, s in sess.items():
        logits = np.concatenate(s.run_distributed_pass())
        digests[f"pass {name}"] = hashlib.sha256(logits.tobytes()).hexdigest()
        ops.reset_launch_counts()
        before = dict(s.halo_stats.bytes_by_tag)
        s.run_distributed_pass()
        torch.cuda.synchronize()
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        counts[name] = {
            "launches": sum(launches.values()),
            "forms": {k: v for k, v in launches.items()
                      if k.startswith("fused_layer/")},
            "halo_bytes": {t: b - before.get(t, 0)
                           for t, b in s.halo_stats.bytes_by_tag.items()
                           if b - before.get(t, 0)},
            "compile_count": s.layer_executor.compile_count}
        res[f"pass {name}"] = {"host_ms": host_ms(s.run_distributed_pass),
                               "launches": launches, **counts[name]}
        print(f"pass {name}: " + json.dumps(res[f"pass {name}"]), flush=True)

    if "--save" in sys.argv:
        path = Path(sys.argv[sys.argv.index("--save") + 1])
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"digests": digests, "counts": counts},
                                   indent=1))
        print(f"saved {len(digests)} digests to {path}")
    if "--compare" in sys.argv:
        path = Path(sys.argv[sys.argv.index("--compare") + 1])
        ref = json.loads(path.read_text())
        bad = [k for k, v in ref["digests"].items() if digests.get(k) != v]
        for k in ref["digests"]:
            print(f"compare {k}: {'DIFFERS' if k in bad else 'bit-equal'}")
        for k, v in ref["counts"].items():
            same = counts.get(k) == v
            print(f"compare {k} launches / forms / halo bytes / programs: "
                  f"{'equal' if same else 'DIFFER: ' + json.dumps(counts.get(k))}")
            if not same:
                bad.append(k)
        if bad:
            sys.exit(f"pair_step0: {len(bad)} differ from {path}'s: {bad}")
        print(f"compare: all {len(ref['digests'])} outputs bit-equal, "
              f"counts equal")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
