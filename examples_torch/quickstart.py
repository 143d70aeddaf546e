"""Quickstart: convert a GCN into a binary GCN with BitGNN's two-level
abstraction, run packed-bit inference, and inspect the memory saving.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

Runs on the CUDA card unless ``--device cpu``; with no card it raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import abstraction, frdc
from repro_torch.graphs.datasets import make_dataset
from repro_torch.models import gnn


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on the card "
                           "(pass --device cpu to run it on the CPU)")
    return dev


def run(device="cuda", params=None, epochs: int = 150) -> dict:
    """The walkthrough; ``params`` replaces the seeded init, and with
    ``epochs=0`` the Bi-GCN is not trained (the carried parameters are
    used as they are). Returns the printed figures."""
    dev = _device(device)
    # 1. a stat-matched synthetic Cora + a trained(-ish) GCN
    d = make_dataset("cora", seed=0, scale=0.25)
    adj = frdc.gcn_normalized(d.edges[0], d.edges[1], d.n_nodes,
                              device=dev)                # exact D^-1/2(A+I)D^-1/2
    adj_bin = d.adjacency("binary", dev)                  # 0/1 bits
    if params is None:
        params = gnn.init_gcn(0, d.x.shape[1], 64, d.n_classes, dev)
    x = torch.from_numpy(d.x).to(dev)
    y = torch.from_numpy(d.y).to(dev)
    loss = float("nan")
    if epochs:
        params, loss = gnn.train_node_classifier(
            gnn.gcn_forward_bigcn, params, (x, frdc.to_dense(adj)), y,
            torch.from_numpy(d.train_mask).to(dev), epochs=epochs, lr=3e-2)
        print(f"trained Bi-GCN, loss={loss:.3f}")

    # 2. drop-in replacement: high-level fused blocks (paper Fig. 2)
    layer1 = abstraction.MMSpMM("BMM.FBB", "BSpMM.BBB")   # binary aggregation
    layer2 = abstraction.MMSpMM("BMM.BBF", "BSpMM.FBF")   # fp aggregation
    abstraction.check_chain("BMM.FBB", "BSpMM.BBB")        # type-checked

    q = gnn.quantize_gcn(params)   # offline weight bit-packing
    h = layer1(gnn.batch_norm(x), q.w1, adj_bin, out_scale=False)
    logits = layer2(h, q.w2, adj)
    acc = gnn.accuracy(logits, y, torch.from_numpy(d.test_mask).to(dev))
    print(f"binary GCN test accuracy: {acc:.3f}")

    # 3. space accounting (paper Tables 3-5 Peak Mem)
    st = frdc.stats(adj_bin)
    print(f"adjacency: FRDC {st['frdc_bytes']/1e3:.1f} KB vs "
          f"CSR-fp32 {st['csr_fp32_bytes']/1e3:.1f} KB "
          f"({st['vs_csr']:.1f}x smaller)")
    w_fp = sum(w.numel() * 4 for w in params)
    w_bit = sum(t.packed.numel() * 4 + t.scale.numel() * 4 for t in q)
    print(f"weights: packed {w_bit/1e3:.1f} KB vs fp32 {w_fp/1e3:.1f} KB "
          f"({w_fp/w_bit:.1f}x smaller)")
    return dict(loss=loss, accuracy=acc, frdc_bytes=st["frdc_bytes"],
                csr_fp32_bytes=st["csr_fp32_bytes"], weight_bytes=w_bit,
                weight_fp32_bytes=w_fp)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
