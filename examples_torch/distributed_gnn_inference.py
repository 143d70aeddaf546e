"""Distributed binary-GNN inference: 1-D block-row partition of the FRDC
adjacency + packed-activation all-gather — the paper's memory saving
turned into a 32x collective saving at multi-chip scale.

    PYTHONPATH=src python examples_torch/distributed_gnn_inference.py [--device cpu]

A one-process simulation, as the JAX example: each shard aggregates its
block-rows in turn, and no collective runs. Runs on the CUDA card unless
``--device cpu``; with no card it raises.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import bitops, frdc
from repro_torch.core.binarize import BinTensor
from repro_torch.core.bspmm import bspmm
from repro_torch.graphs import partition
from repro_torch.graphs.datasets import make_dataset


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on the card "
                           "(pass --device cpu to run it on the CPU)")
    return dev


def run(device="cuda") -> dict:
    """The walkthrough; returns the printed figures."""
    dev = _device(device)
    d = make_dataset("cora", seed=0, scale=0.3)
    n_shards = 4
    shards = partition.partition_rows(d.edges[0], d.edges[1], d.n_nodes,
                                      n_shards, kind="gcn", device=dev)
    balance = partition.shard_stats(shards)
    print("shard balance:", balance)

    rng = np.random.default_rng(0)
    act = rng.choice([-1.0, 1.0], size=(d.n_nodes, 64)).astype(np.float32)
    xt = BinTensor(packed=bitops.pack_bits(torch.from_numpy(act > 0).to(dev)),
                   scale=torch.ones((d.n_nodes, 1), device=dev), n=64)

    # each "chip" aggregates its block-rows from the globally-gathered PACKED
    # activations (the all-gather payload is bits: 64 feats -> 2 words/node)
    outs = []
    for s in shards:
        local = bspmm(s.adj, xt, "BBF")
        outs.append(local[: s.row_end - s.row_start].cpu().numpy())
    dist = np.concatenate(outs)[: d.n_nodes]

    full = frdc.gcn_normalized(d.edges[0], d.edges[1], d.n_nodes, device=dev)
    want = bspmm(full, xt, "BBF").cpu().numpy()
    err = float(np.abs(dist - want).max())
    print(f"distributed == global: max|err| = {err:.2e}")

    # 4 bytes a word, as the reference's uint32 words
    packed_payload = bitops.packed_memory_bytes(xt.packed, 64)
    fp_payload = d.n_nodes * 64 * 4
    print(f"all-gather payload: packed {packed_payload/1e3:.1f} KB vs "
          f"fp32 {fp_payload/1e3:.1f} KB ({fp_payload/packed_payload:.0f}x)")
    return dict(balance=balance, max_err=err, packed_payload=packed_payload,
                fp_payload=fp_payload)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
