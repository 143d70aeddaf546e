"""Paper §3.4 tuning utilities demo: enumerate type-correct precision-variant
assignments for a 2-layer binary GCN, time each on the actual graph, and
report the accuracy/latency frontier.

    PYTHONPATH=src python examples_torch/tune_variants.py [--device cpu]

Runs on the CUDA card unless ``--device cpu``; with no card it raises. The
latencies are the card's (each call synchronized); the candidate list and
each output delta do not depend on the hardware.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import abstraction, frdc, tuner
from repro_torch.graphs.datasets import make_dataset
from repro_torch.models import gnn


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on the card "
                           "(pass --device cpu to run it on the CPU)")
    return dev


def run(device="cuda", params=None) -> dict:
    """The walkthrough; ``params`` replaces the seeded init. Returns the
    candidate count, the results and the best candidate."""
    dev = _device(device)
    d = make_dataset("cora", seed=0, scale=0.2)
    adj = frdc.gcn_normalized(d.edges[0], d.edges[1], d.n_nodes, device=dev)
    adj_bin = d.adjacency("binary", dev)
    x = torch.from_numpy(d.x).to(dev)
    if params is None:
        params = gnn.init_gcn(0, d.x.shape[1], 32, d.n_classes, dev)
    q = gnn.quantize_gcn(params)
    reference = gnn.gcn_forward_fp(params, x, frdc.to_dense(adj))

    candidates = tuner.legal_two_layer_candidates(first_in="F", last_out="F")
    print(f"{len(candidates)} type-correct candidates")

    def build(cand: tuner.Candidate):
        (m1, s1), (m2, s2) = cand.layer_variants
        l1 = abstraction.MMSpMM(m1, s1)
        l2 = abstraction.MMSpMM(m2, s2)

        def fwd(x):
            a1 = adj_bin if s1.endswith("BBB") or "BB" in s1 else adj
            h = l1(gnn.batch_norm(x), q.w1, a1,
                   trinary_mode=cand.trinary_mode, out_scale=False)
            if not isinstance(h, torch.Tensor):
                return l2(h, q.w2, adj)
            return l2(gnn.batch_norm(h), q.w2, adj)
        return fwd

    results = tuner.tune(build, (x,), candidates[:8], reference=reference,
                         repeats=2)
    print(f"{'candidate':70s} {'ms':>8s} {'delta':>8s}")
    for r in results:
        print(f"{r.candidate.name():70s} {r.latency_s*1e3:8.2f} "
              f"{r.output_delta:8.3f}")
    best = tuner.best(results)
    print(f"\nbest: {best.candidate.name()} @ {best.latency_s*1e3:.2f} ms")
    return dict(n_candidates=len(candidates), results=results, best=best)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
