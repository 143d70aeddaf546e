#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit:  ``python3 chip_smoke.py``

Phases (each raises on failure; the script then exits 1 and prints no
result):

1. build — compile the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, in parallel; phases 2-4's first), while the host makes the
   datasets and their FRDC matrices and then runs phases 2-3; phase 4
   waits for the whole build;
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
   (bit-equal); fc, its own launch (``fused_fc``), also bit-exact against
   its mirror ``fc_rows_plain``;
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
   layer also per kind, whole and transform-only (fc, one launch with no
   aggregation, whole only), beside its yardstick:
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
   |terms|; fc also bit-exact against its mirror), with its bound, on
   events and device time (fc beside a bf16 matmul yardstick); the pair
   kernel
   (``fused_pair``) alone on each pair form's transform against its plain
   version, each form's step (transform + pair) and pair times, the
   pair's bound, registers and occupancy, and one ``torch.sparse.mm`` of
   [intra | halo] as its library yardstick.
11-12. engines (see ``run_engine``).
13. training — full Flickr at hidden 64, weights from a seeded numpy
   generator, the adjacencies sparse (``gnn.sparse_adjacency``: CSR and
   its transpose), fp32 products (``run`` sets TF32 off; the phase holds
   the first layer's product on 4,096 rows against float64 on the host
   within TF32_CHECK of its scale, which a TF32 product misses by ~2e-4):
   fp32 GCN (150 epochs, lr 1e-2),
   Bi-GCN GCN, STE "bin" GCN and Bi-GCN SAGE (300 epochs, lr 3e-2) trained
   on the card with ``train_node_classifier``; their weights quantized and
   run through the packed forwards (Ours(full), Ours(bin), SAGE Ours) on
   the kernels, each held against the same forward on the CPU by the rule
   of phase 3, every kernel of the path launched; Ours(full)'s logits
   within rtol = atol = 2e-2 of the Bi-GCN forward's on the card (the
   reference's ``tests/test_gnn.py`` bound, which holds whether or not the
   model learned); the accuracy table, with Ours(full) within 0.04 of
   Bi-GCN, Ours(bin) at least STE "bin" - 0.05
   and SAGE Ours at least SAGE Bi-GCN - 0.06; the trained "bin" GCN served
   from ``GraphStore(max_batch=32, khop=2, use_pallas=True, fused=True)``
   for 4 batches of 32 seeded seeds, held against the card's full-graph
   forward, fused launches only, no new program after warmup; then the
   five backends of Tables 3-5 on the trained GCN weights as
   ``benchmarks/bench_gnn_tables.py`` composes them (FP32(S) scatter,
   FP32(T) and Bi-GCN on the sparse adjacency, Ours(full), Ours(bin)) and
   SAGE's three: median ms (CUDA events), peak memory over the forward,
   speedup against the first row.
14. replica tier (``run_replica``) — full Flickr, GCN "bin" with phase 6's
   weights: (a) ``FrontDoor(spread="query")`` over two single-host
   replicas (``build_replica``, ``fused=True``, batch 32, pipeline depth
   1), each with its own ``GraphStore`` on the card and a heartbeat
   deadline of half a warm batch's serve time; a wave of 128 seeded
   queries, one tick (a batch answered on each replica, the next
   extracting), ``kill("r1")``, the deadline lapsed, drained: every query
   answered, one failover, the moved queries on r0, only r1 marked down, no
   program on either replica after warmup, both replicas' ``batch_log``
   bit-equal replayed on a single-host card session; r1 revived,
   readmitted, 64 more queries on both; (b) ``update_features`` on 1% of
   the rows and 64 queries: each answer bit-equal to a session built on
   the new features, every query pinned before the update answered before
   it; (c) one replica with ``ShardedServeEngine`` at P = 2 (host
   executor, 1D kernels): 64 steady queries, 64 more in flight, a
   ``Resharder`` to P = 4 prepared on its thread while the old engine
   ticks, 32 queries queued across the swap, ``swap()``, 64 on P = 4: zero
   shed, the swap's drain answers the 32, ``routing.json`` of P2 written,
   reshard phases prepared / swap_begin / swap_end; the new engine's
   batches bit-equal on a freshly built P = 4 stack, the old engine's by
   the rule of phase 3 there, both against the single-host session
   bit-equal or by that rule (the line says which). Each part's kernels
   must launch (fused_layer; rows 1-4 in (c)).
15. token tier (``run_token``) — the binary transformer / SSM / MoE stack,
   bf16, seeded weights from a ``torch.Generator`` on the card. It runs
   none of the kernels above: its products are cuBLAS calls, as the
   reference's are XLA dots. Each model runs at the registry's width cut
   in depth (``depth_cut``: 2 layers, or where a block kind first runs;
   a line lists each cut), which keeps every check at a fraction of the
   full depth's host-bound decode. (a) ``stablelm-1.6b`` (2 of 24 layers)
   in one ``TokenStore(max_batch=4, max_len=512, chunk=8)``, registered fp
   and ``quantize=True`` (bit-packed projections); each through
   ``TokenServeEngine(pipeline_depth=1)``: warmup, then 16 requests
   (prompts of 8-128 tokens, ``max_new`` 16-64, from ``default_rng(SEED +
   9)``): every query answered with ``t_first_token`` set, no new program
   after warmup, every served batch bit-equal to a stepwise
   ``decode_step`` loop on the card at the session's batch and cache
   length (``stepwise``); a depth-1 drain with the launch stage
   inside ``strict_guard()`` reads 0 ``host_sync_in_launch``; one
   sequence's teacher-forced logits on the card against the same
   ``decode_chunk`` on the CPU within the reference's rtol = atol = 0.15.
   (b) ``rwkv6-3b`` (2 of 32 layers) through ``TokenSession.run``,
   fp and quantized: the same bit-equality, and ``decode_chunk`` bit-equal
   to stepwise decode, logits and every cache leaf. (c) every arch of
   ``configs.ARCHS`` at full width, cut in depth the same way: finite
   logits, ``decode_step`` against ``forward`` by the 0.15 rule (not vlm,
   as the reference), and two decodes of
   ``qwen2-moe-a2.7b`` bit-equal. Prints tokens/s, TTFT p50/p99, ms a
   decode step (host clock and CUDA events), the device's idle share over
   one chunk (torch.profiler), fp and packed parameter bytes, peak memory
   and the phase's seconds.
16. LM training (``run_lm_train``) — no GNN kernel runs here either. (a)
   ``smollm-135m`` at full width (30 layers, d 576, vocab 49,152, bf16),
   weights from a ``torch.Generator`` on the card, through ``Trainer`` with
   ``launch/train.py``'s recipe (AdamW on a cosine schedule, peak 3e-3,
   clip 1.0; ``SyntheticLM(vocab, 128)``, batch 8; a checkpoint every 25
   steps) for 60 steps, with a ``FailureInjector`` at step 30 under
   ``run_with_restarts``: one restart, the resumed run 35 steps from step
   25, the state it restores bit-equal to the one saved at 25, every leaf
   float32 after step 1 (the reference's AdamW promotion), the mean loss
   of the last 5 steps below the first 5 less 0.1
   (``tests/test_distribution.py``'s rule). Prints ms a step (host clock
   and CUDA events; step 21 under torch.profiler for the device's busy ms
   and launches, step 22 with its AdamW update timed alone), the idle
   share, the checkpoint save calls and the restore in seconds, and peak
   memory. (b) one loss and gradient step of each block family
   (smollm-135m, qwen2-moe-a2.7b, zamba2-1.2b, rwkv6-3b,
   seamless-m4t-medium) at full width, cut in depth as in 15 (c) (a
   ``reduced`` line lists the cuts): finite loss, finite gradient norm
   above 0. (c) ``block_remat`` on (a)'s config, one loss and gradient
   step: the loss bit-equal to the plain forward's, every gradient leaf
   within 1e-2 of its max |g|, both peak-memory readings.
17. the dry run (``run_dryrun``) — no kernel runs. (a) the full configs'
   cells through the launchers, ``launch/train.py --arch smollm-135m
   --mesh single`` (train_4k, with probes) and ``launch/serve.py --arch
   stablelm-1.6b --mesh single`` (decode_32k, whole): each traced on meta
   DTensors over the (16, 16) mesh of a fake process group; prints the
   per-device HBM bytes (and whether they fit the card), flops, bytes,
   collective bytes by op and the seconds; then the train cell traced at
   its full depth, whose flops, bytes and collective bytes the probes
   must equal within 1e-9. (b) the estimate against the card: the dry
   run's trace on a 1 x 1 host mesh of 16a's first step (smollm-135m,
   batch 8 x 128, AdamW, fresh ``init_params`` and ``opt.init``) and of one
   ``decode_step`` of stablelm-1.6b at batch 4, cache 512, against
   ``torch.cuda.max_memory_allocated()`` over the same step on the card
   (above what lived before its arguments were built; two steps from fresh
   arguments): the phase fails where an estimate sits more than 15% below
   a measured peak. Then one train step of qwen2-moe-a2.7b at full width
   cut to 2 layers with global dispatch (``moe_groups=0``, batch 8 x 128,
   AdamW) on plain tensors and under ``param_shardings(fsdp=True)`` on the
   1 x 1 host mesh, from one seeded state and batch: the two losses must
   be bit-equal.

19. the LM mesh paths (``run_lm_mesh``) — no GNN kernel runs. Gloo ranks
   share the one card (NCCL refuses two ranks on one GPU); a probe world
   first asks whether DTensor's all-gather runs on device tensors over
   gloo, and the phase prints the placements it ran and why. (a) the
   expert-parallel MoE (``moe_groups=-1``): ``qwen2-moe-a2.7b`` at full
   width cut to 2 layers, fp32, B = 2 x 32 tokens, in 2 ranks on a (1, 2)
   mesh, then 4 ranks on (2, 2) (the world of 2 runs (b) after (a),
   each part checked on its own results); the experts sharded over
   ``model`` (30 a rank), the rest replicated, the batch over ``data``.
   Each rank holds its logits against the plain forward on the card
   (``moe_groups`` 0, or the data size) within 1e-4 of max |logits| with
   equal argmax, one loss and gradient step (loss within 1e-5 relative;
   its expert gradients within 1e-4 of each leaf's max |g| of the plain
   gradient's slice), and one all-reduce a MoE layer in the forward;
   prints ms a forward and a step and the collective bytes a rank. (b) ``Trainer(shardings=)``:
   ``smollm-135m`` at full width cut to 2 layers with 16a's recipe in 2
   ranks, ``run_with_restarts`` over 8 steps, a checkpoint every 4 and a
   failure at 4; the restart restores under FSDP placements over (2, 1),
   or data-parallel ones where the probe refuses the all-gather. Steps 0-3
   (the fresh start's plain state) bit-equal to the same recipe's run in
   this process (``mesh_reference_losses``), steps 4-7 within 1e-3
   relative, every rank's losses equal, every leaf's placements kept
   by every step, the final checkpoint written by rank 0 alone and, restored
   in this process, equal to what the ranks gathered (SHA-256 a leaf);
   prints ms a sharded step, collective bytes a step and peak memory a
   rank. (c) the A3 dry-run cell: ``run_cell(qwen2-moe-a2.7b, train_4k,
   single)`` with ``moe_groups`` -1 and 0 (the global dispatch) at full
   depth without probes: per-device peak and collective bytes by op; a
   failure of either fails the run. The parent traces (c) on meta tensors
   while the probe's world runs.
20. the example twins (``run_examples``) — first ``ops.launch_stats`` of
   one GCN "bin" bucket forward of serve ways (a) and (c) (32 seeds, full
   Flickr): aten ops and kernel entries, per call and per layer, each
   entry one CUDA launch, fewer ops fused; then every twin of
   ``examples_torch/`` through its ``main`` on the card (``TWIN_RUNS``):
   ``quickstart``, ``distributed_gnn_inference`` and ``tune_variants`` at
   their defaults, ``serve_gnn`` and ``serve_sharded`` at ``--scale 1.0``
   (P = 4), ``serve_replicated`` at its defaults, ``serve_llm`` fp and
   ``--quant``, ``train_lm --layers 6 --steps 60 --fail-at 30`` (a
   checkpoint at 20, one restart). Each twin holds every assert of its
   JAX example, and any failure fails the run; prints each twin's wall
   seconds and key figures (QPS, p50, tokens/s, final loss, restarts),
   and the rows 1-4 kernels must have launched.

Output: a JSON line with one record per kernel, the card's name and power
limit from nvidia-smi, a ``walls:`` record of each phase's seconds (within
it those of reference work, timing loops and the worlds' start-up; a
record, not a gate), and last the line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HIDDEN = 64          # the paper's hidden width (benchmarks/bench_gnn_tables.py)
SEED = 0
DEVICE = "cuda"
BUILD_FIRST = ("pack", "bmm", "bspmm")   # the kernels of phases 2-4
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
INT8_TC_OPS_PER_S = 1979e12  # lowest-precision tensor-core rate in the table
FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores
FP_TOL, FP_TOL_ABS = 1e-5, 1e-6   # bspmm_fp vs plain, see hold()
ROWS_CLOSE_MIN = 0.999
PRED_AGREE_MIN = 0.999
TF32_CHECK = 1e-5          # phase 13: fp32 product vs float64, of max |ref|
FULL_VS_BIGCN = 2e-2       # phase 13: Ours(full) vs Bi-GCN logits, rtol=atol
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
    "fused_pair": ("src/repro_torch/csrc/fused_pair.cu",
                   "src/repro/kernels/fused_layer.py:163"),
}
# the fused layer's sharded forms (rows 7e-7h): each kind's step with its
# halo pair (the transform, then the pair kernel), and fc with BN by the
# reciprocal
PAIR_KINDS = ("gcn_bin_l1+halo", "gcn_bbf_fbf+halo", "branch_add+halo",
              "fc+rcp")
REPLACES.update({f"fused_layer/{k}": REPLACES["fused_pair" if "+halo" in k
                                              else "fused_layer"]
                 for k in PAIR_KINDS})
FORWARD_KERNELS = ("binarize_pack", "bmm_xnor", "bspmm_bits", "bspmm_fp")
SERVE_KERNELS = ("bspmm_bits_grid", "bspmm_fp_grid", "fused_layer")
TASK_FIELDS = ("tasks", "n_part")   # a fused bucket's task list (adapters)
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
TRAIN_BATCHES = 4          # phase 13: served batches on trained weights
REPLICA_WAVE = 128         # phase 14: the failover wave's queries
REPLICA_QUERIES = 64       # phase 14: each later wave's queries
TOKEN_REQUESTS = 16        # phase 15: requests to each stablelm engine
TOKEN_BATCH = 4            # phase 15: the token store's max_batch
TOKEN_MAX_LEN = 512        # phase 15: the token store's max_len
TOKEN_CHUNK = 8            # phase 15: decode steps a launch
TOKEN_TOL = 0.15           # phase 15: the reference's forward-vs-decode rule
# phases 15, 16 (b), 19: each arch's depth at full width (2 layers
# otherwise; zamba2's shared attention block runs at every 6th layer)
TOKEN_DEPTH = {"zamba2-1.2b": dict(n_layers=6),
               "seamless-m4t-medium": dict(enc_layers=2, dec_layers=2)}
LM_ARCH = "smollm-135m"    # phase 16: the LM trained at full width
LM_STEPS = 60              # phase 16 (a): total steps of the run
LM_FAIL_AT = 30            # phase 16 (a): the injected failure's step
LM_CKPT_EVERY = 25         # phase 16 (a): launch/train.py's interval
LM_BATCH, LM_SEQ = 8, 128  # phase 16 (a): launch/train.py's defaults
LM_LR = 3e-3               # phase 16 (a): launch/train.py's peak lr
LM_DROP = 0.1              # phase 16 (a): tests/test_distribution.py's rule
LM_PROFILE_STEP = 20       # phase 16 (a): the step run under torch.profiler,
                           # the next with its AdamW update timed alone
GRAD_ARCHS = ("smollm-135m", "qwen2-moe-a2.7b", "zamba2-1.2b", "rwkv6-3b",
              "seamless-m4t-medium")   # phase 16 (b): every block family
GRAD_B, GRAD_T = 2, 32     # phase 16 (b): tests/test_arch_smoke.py's batch
REMAT_TOL = 1e-2           # phase 16 (c): remat grads, of each leaf's max |g|
DRY_SERVE_ARCH = "stablelm-1.6b"   # phase 17 (a): launch/serve.py's default
DRY_DECODE = (4, 512)      # phase 17 (b): decode batch, cache length (15a's)
DRY_UNDER = 0.15           # phase 17 (b): the most an estimate may fall short
DRY_MOE = (8, 128)         # phase 17 (b): the MoE step's batch and tokens
# phase 13: model -> (training forward, family, adjacency kinds, epochs, lr),
# the recipes of benchmarks/accuracy_experiment.py
TRAIN = {"FP32": ("gcn_forward_fp", "gcn", ("gcn",), 150, 1e-2),
         "Bi-GCN": ("gcn_forward_bigcn", "gcn", ("gcn",), 300, 3e-2),
         "STE-bin": ("gcn_forward_ste_bin", "gcn", ("binary", "gcn"), 300,
                     3e-2),
         "SAGE Bi-GCN": ("sage_forward_bigcn", "sage", ("mean",), 300, 3e-2)}
SPMD_PASSES = 3            # phase 18: timed passes of each way a rank
SPMD_TIMEOUT_S = 420       # phase 18: the world's limit, start to join
ALLREDUCE_N = 1 << 20      # phase 18: floats of each rank's gradient
# the distributed passes: name -> (family, scheme, fused)
SHARDED_WAYS = {"gcn_bin/unfused": ("gcn", "bin", False),
                "gcn_bin/fused": ("gcn", "bin", True),
                "gcn_full/fused": ("gcn", "full", True),
                "sage/fused": ("sage", "fixed", True),
                "saint/fused": ("saint", "fixed", True)}
EP_ARCH = "qwen2-moe-a2.7b"  # phase 19 (a): the expert-parallel MoE
EP_LAYERS = 2              # phase 19 (a): depth cut, as 16b
EP_B, EP_T = 2, 32         # phase 19 (a): tokens, 16b's batch
EP_MESHES = ((1, 2), (2, 2))   # phase 19 (a): (data, model) of each world
EP_LOGIT_TOL = 1e-4        # phase 19 (a): logits, of max |logits|
EP_LOSS_TOL = 1e-5         # phase 19 (a): the loss, relative
EP_GRAD_TOL = 1e-4         # phase 19 (a): expert gradients, of max |g|
MESH_LAYERS = 2            # phase 19 (b): depth cut, as 16b
MESH_STEPS = 8             # phase 19 (b): the sharded Trainer's steps
MESH_CKPT_EVERY = 4        # phase 19 (b): its checkpoint interval
MESH_FAIL_AT = 4           # phase 19 (b): its injected failure
MESH_LOSS_TOL = 1e-3       # phase 19 (b): steps 4-7 against one process
MESH_TIMEOUT_S = 300       # phase 19: each world's limit
# phase 20: each example twin's arguments (the sizes of the JAX examples'
# docstrings; train_lm at its docstring's 6 layers, failing once after a
# checkpoint)
TWIN_RUNS = (
    ("quickstart", []),
    ("distributed_gnn_inference", []),
    ("tune_variants", []),
    ("serve_gnn", ["--scale", "1.0"]),
    ("serve_sharded", ["--scale", "1.0", "--shards", "4"]),
    ("serve_replicated", []),
    ("serve_llm", []),
    ("serve_llm", ["--quant"]),
    ("train_lm", ["--layers", "6", "--steps", "60", "--fail-at", "30"]),
)
STATS_LAYERS = 2           # phase 20: GCN layers of the launch_stats lines


def log(msg: str) -> None:
    print(msg, flush=True)


# the ``walls:`` line: each phase's seconds, and inside it those of its
# reference work (the checks' CPU forwards, twin sessions, stepwise
# replays), its timing loops and its worlds' start-up and tear-down
WALLS = {}
_OPEN = {"phase": None, "part": None, "t0": 0.0}


def begin(name) -> None:
    """End the open phase of the ``walls:`` line and open ``name`` (None:
    none)."""
    now = time.perf_counter()
    add_wall(_OPEN["phase"], "s", now - _OPEN["t0"])
    _OPEN.update(phase=name, t0=now)


def add_wall(name, key: str, s: float) -> None:
    if name is not None:
        row = WALLS.setdefault(name, {})
        row[key] = row.get(key, 0.0) + s


@contextlib.contextmanager
def part(kind: str):
    """Add the block's seconds to the open phase's ``<kind>_s`` (a part
    inside another counts once, in the outer one)."""
    if _OPEN["part"] is not None:
        yield
        return
    t0 = time.perf_counter()
    _OPEN["part"] = kind
    try:
        yield
    finally:
        _OPEN["part"] = None
        add_wall(_OPEN["phase"], f"{kind}_s", time.perf_counter() - t0)


def timing(fn):
    """``fn`` counted as a timing loop of the open phase."""
    @functools.wraps(fn)
    def timed(*args, **kw):
        with part("timing"):
            return fn(*args, **kw)
    return timed


def stamped(fn, rank: int, *args):
    """``fn(rank, *args)`` between wall-clock stamps (runs in the rank)."""
    t0 = time.time()
    out = fn(rank, *args)
    return t0, time.time(), out


def world(fn, n: int, *args, **kw) -> list:
    """``run_ranks(fn, n, *args, **kw)``. The world's wall less its ranks'
    work (first entry into ``fn`` to last exit) goes to the open phase's
    ``startup_s``; the whole wall where the world fails."""
    from repro_torch.launch.mesh import run_ranks
    t0 = time.perf_counter()
    try:
        outs = run_ranks(functools.partial(stamped, fn), n, *args, **kw)
    except BaseException:
        add_wall(_OPEN["phase"], "startup_s", time.perf_counter() - t0)
        raise
    work = max(o[1] for o in outs) - min(o[0] for o in outs)
    add_wall(_OPEN["phase"], "startup_s", time.perf_counter() - t0 - work)
    return [o[2] for o in outs]


@timing
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


@timing
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


@timing
def device_ms(torch, fn, iters: int = 20, tries: int = 3) -> float:
    """Mean device ms a call of ``fn`` spends in kernels and memsets
    (torch.profiler), after one warm-up: unlike ``cuda_ms`` it leaves out
    the time the card waits for the host between launches. The profiler
    can lose kernel records (seen in a process that had loaded several
    builds of one kernel, and after the serve phase), so each kernel counts
    its mean over the launches recorded, times its launches a call, and a
    window with no device record at all is profiled again, up to
    ``tries`` windows."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
                t = e.device_time_total if hasattr(e, "device_time_total") \
                    else e.cuda_time_total
                total += t / e.count * max(1, round(e.count / iters))
        if total:
            break
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
    its device, (n_tile_rows * 4, n_cols), decoded by
    ``frdc.nonzero_coords``: ``torch.sparse.mm`` of it with +-1 features
    as float32 gives the bits kernels' trinary counts (integers below
    2^24, exact)."""
    import numpy as np
    from repro_torch.core import frdc
    rows, cols = frdc.nonzero_coords(adj)
    idx = torch.from_numpy(np.stack([rows, cols])).to(adj.device)
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


def drive(torch, launches, path, expect, fn):
    """Drive one path with the launch counts set to 0 just before it and
    read just after; fail if a kernel of ``expect`` never launched. Adds
    the counts to ``launches``; returns (what ``fn`` returned, the
    counts)."""
    from repro_torch.kernels import ops
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


def agree(what, got, want) -> tuple:
    """The rule of phase 3 on host logits: rows allclose(rtol = atol =
    1e-3) and predictions equal, each on at least 99.9% of rows. Returns
    (rows close, predictions equal, max |dlogit|)."""
    import numpy as np
    close = float(np.isclose(got, want, rtol=1e-3, atol=1e-3)
                  .all(axis=1).mean())
    same = float((got.argmax(1) == want.argmax(1)).mean())
    worst = float(np.abs(got - want).max())
    log(f"agree {what}: rows close {close:.6f}, predictions {same:.6f}, "
        f"max |dlogit| {worst:.3e}")
    if close < ROWS_CLOSE_MIN or same < PRED_AGREE_MIN:
        raise AssertionError(f"{what}: answers disagree")
    return close, same, worst


def run(torch) -> dict:
    from concurrent.futures import ThreadPoolExecutor

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

    # -- 1. build, with the data and phases 2-3 beside it ---------------------
    # nvcc runs in processes of its own, on a thread here: first the
    # sources of phases 2-4 (BUILD_FIRST), then the others; the host makes
    # the datasets and their FRDC matrices meanwhile, and phases 2-3 run
    # while the rest compiles (fused_layer.cu is the long pole, one core).
    # Phase 4 times the kernels, so it waits for the whole build.
    begin("1 build + data")
    t0 = t_build = time.perf_counter()
    rest = tuple(n for n in build.SOURCES if n not in BUILD_FIRST)

    def build_s(names):
        build.build_all(names)
        return time.perf_counter() - t_build

    pool = ThreadPoolExecutor(1)
    built = [pool.submit(build_s, names) for names in (BUILD_FIRST, rest)]
    pool.shutdown(wait=False)
    flickr = make_dataset("flickr", seed=SEED, scale=1.0)
    reddit = make_dataset("reddit", seed=SEED, scale=0.1)
    log(f"datasets: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    adjs = {
        "flickr": {k: flickr.adjacency(k, dev)
                   for k in ("gcn", "binary", "mean")},
        "reddit": {k: reddit.adjacency(k, dev) for k in ("gcn", "binary")},
    }
    log(f"FRDC build: {time.perf_counter() - t1:.1f} s")
    first_s = built[0].result()
    for name, d in (("flickr", flickr), ("reddit", reddit)):
        a = adjs[name]["binary"]
        log(f"{name}: nodes {d.n_nodes} edges {d.n_edges} feats "
            f"{d.x.shape[1]} classes {d.n_classes} groups(binary) "
            f"{a.n_groups} groups(gcn) {adjs[name]['gcn'].n_groups}")

    # -- 2. parity ----------------------------------------------------------
    begin("2 parity")
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
    begin("3 main path")
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
        with part("reference"):
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

    begin("1 build (wait)")
    log(f"build: {built[1].result():.2f} s for {len(build.SOURCES)} "
        f"sources {build.SOURCES} ({first_s:.2f} s for {BUILD_FIRST}), "
        f"with the data and phases 2-3 beside it")

    # -- 4. times at the main-path shapes ------------------------------------
    begin("4 times")
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
    begin("5-7 serve")
    serve_records, single, params, stores = run_serve(torch, flickr,
                                                      adjs["flickr"])
    records += serve_records
    with tempfile.TemporaryDirectory(prefix="sharded-") as art:
        begin("8-10 sharded")
        sharded_records, sharded_store, phase8 = run_sharded(
            torch, flickr, single, params, art)
        records += sharded_records
        begin("18 spmd")
        spmd_launches = run_spmd(torch, art, phase8)
    for rec in records:
        per_rank = [ls.get(rec["name"], 0) for ls in spmd_launches]
        rec["launches"] += sum(per_rank)
        rec["spmd_launches_per_rank"] = per_rank
    # the engine paths' launches join each kernel's count
    begin("11-12 engines")
    engine_launches = run_engine(torch, flickr, stores, sharded_store, single)
    begin("13 train")
    train_launches = run_train(torch, flickr, adjs["flickr"])
    begin("14 replica")
    replica_launches = run_replica(torch, flickr, params)
    for rec in records:
        rec["launches"] += sum(ls.get(rec["name"], 0) for ls in (
            engine_launches, train_launches, replica_launches))
    begin("15 token")
    run_token(torch)
    begin("16 lm train")
    run_lm_train(torch)
    begin("17 dry run")
    run_dryrun(torch)
    begin("19 lm mesh")
    run_lm_mesh(torch)
    begin("20 twins")
    twin_launches = run_examples(torch, stores)
    begin(None)
    for rec in records:
        rec["launches"] += twin_launches.get(rec["name"], 0)
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
    """While active, every launch of the cooperative fused layer kernel
    runs with ``aggregate = 0``, so the kernel returns after its transform
    phase: the wrapper builds its parameters as always, and only the flag
    in the struct it passes changes. Without aggregation the transform
    writes its products (the self branch's too) without the column scale.
    fc's own launch (``fused_fc``) is not patched."""

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
    its plain version, its yardstick (one PyTorch call of the transform's
    product) and the bounds of both, on CUDA events (tools/xform_step0.py takes the device
    times: after the serve phase torch.profiler under-counts here); fc is
    its own launch (fused_fc), which ``transform_only`` does not reach, so
    its whole time stands as its transform time. Then the kernels'
    registers and occupancy at each kind's dynamic shared memory."""
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
            lambda: fl.gcn_bin_l1(x_pad, bn[0], q.w1, bin_b, tasks=items["bin"]),
            (f, True, False),
            ("fp32 torch.matmul(z, w_eff)", lambda: z @ w_eff),
            4 * n * f + 8 * f + 4 * h * (wk_f + 1), 4 * n * wh, 4 * n * wh, "bin",
            [(2 * n * f * h, FP32_OPS_PER_S)],
            [(2 * nnz["bin"] * h, INT8_TC_OPS_PER_S)]),
        "gcn_bbf_fbf (words 64 -> 7)": (
            lambda: fl.gcn_bbf_fbf(h_pad, None, q.w2, adj_b, tasks=items["adj"]),
            (h, False, False),
            ("bf16 torch.matmul", lambda: a_h @ b_hc),
            4 * n * wh + 4 * c * (wh + 1), 4 * n * c, 4 * n * c, "adj",
            [(2 * n * c * h, INT8_TC_OPS_PER_S)],
            [(2 * nnz["adj"] * c, FP32_OPS_PER_S)]),
        "branch_add (500 -> 64)": (
            lambda: fl.branch_add(x_pad, bn[0], d["w1"], d["w1b"], adj_b,
                                  tasks=items["adj"]),
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
    plains = {   # each kind's plain version on the same inputs
        "gcn_bin_l1 (500 -> 64)": lambda: fl.gcn_bin_l1_plain(
            x_pad, bn[0], q.w1, bin_b),
        "gcn_bbf_fbf (words 64 -> 7)": lambda: fl.gcn_bbf_fbf_plain(
            h_pad, None, q.w2, adj_b),
        "branch_add (500 -> 64)": lambda: fl.branch_add_plain(
            x_pad, bn[0], d["w1"], d["w1b"], adj_b),
        "fc (64 -> 7)": lambda: fl.fc_plain(x_h, bn_h, d["w2"]),
    }
    out, attrs = {}, {}
    for name, (call, layer, (yname, yard), b_in, b_y, b_out, adj, ops_t,
               ops_a) in kinds.items():
        row = {"whole_ms": cuda_ms(torch, call),
               "plain_ms": cuda_ms(torch, plains[name], iters=5, warmup=1)}
        if adj is None:   # fc: one fused_fc launch, no aggregation
            row["transform_ms"] = row["whole_ms"]
            row["transform_note"] = ("fused_fc has no aggregation: its "
                                     "whole time is its transform's")
        else:
            with transform_only(build):
                row["transform_ms"] = cuda_ms(torch, call)
        row["whole_bound_ms"], row["whole_bound_by"] = bound(
            b_in + b_out + (agg_bytes[adj] if adj else 0), ops_t + ops_a)
        row["transform_bound_ms"], row["transform_bound_by"] = bound(
            b_in + b_y, ops_t)
        row["yardstick"] = yname
        row["yardstick_ms"] = cuda_ms(torch, yard)
        out[name] = row
        attrs[name] = fl.attributes(*layer) if adj else fl.fc_attributes(h)
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


def run_serve(torch, flickr, adjs) -> tuple:
    """Phases 5-7: the serving slice on full Flickr (``adjs``: phase 1's
    full-graph FRDC matrices by kind, on the card). Returns the kernel
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
        {f: v.to(dev) for f, v in a.items() if f not in TASK_FIELDS},
        n_pad, n_pad, nnz[k]) for k, a in staged.adjs.items()}
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
    full_bin = adjs["binary"]                       # the 1,399-group row
    full_gcn = adjs["gcn"]
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
            if kind == "fc":       # fused_fc against its mirror, bit-exact
                hold("fused_layer", got, fl.fc_rows_plain(*args))
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
        with part("reference"):
            twin = CompiledGraphSession(
                sess.graph, sess.model, sess.plan,
                type(sess.qparams)(*(cpu(w) for w in sess.qparams)),
                khop=sess.khop, max_batch=sess.max_batch,
                adj_full={k: m.to("cpu") for k, m in sess._adj_full.items()},
                use_pallas=True, device="cpu")
            twin.bn = cpu(sess.bn)                # the card's frozen BN
            twin.feature_version = sess.feature_version
            on_cpu = np.concatenate([twin.serve_subgraph(seeds[i])
                                     for i in range(n_b)])
        agree(f"{name} vs the CPU", served[name], on_cpu)
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
    items = {k: fused_layer.PairItems(a["tasks"].to(dev), a["n_part"])
             for k, a in staged.adjs.items()}

    def fused_fwd():
        h = fused_layer.gcn_bin_l1(x_pad, bn[0], q.w1, bin_b,
                                   tasks=items["bin"])
        return fused_layer.gcn_bbf_fbf(h, None, q.w2, adj_b,
                                       tasks=items["adj"])

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


def pair_library(torch, fl, a, h, y, rem, ho, mag):
    """(name, call) of the pair aggregation's library yardstick, one
    ``torch.sparse.mm`` of the CSR of [intra | halo] (values: row scale
    times column scale) with cat(y, rem) (+-1 float rows for sign words,
    which gives the integer counts), after holding its result to the plain
    pair's sums: counts equal, fp within FP_TOL of ``mag``."""
    import numpy as np
    from repro_torch.core import bitops, frdc
    ra, ca = frdc.nonzero_coords(a)
    rh, ch = frdc.nonzero_coords(h)
    rows = np.concatenate([ra, rh])
    cols = np.concatenate([ca, ch + y.shape[0]])
    vals = np.ones(rows.size, np.float32)
    if mag is not None:
        def scale(t, n):
            return np.ones(n, np.float32) if t is None else t.cpu().numpy()
        col = np.concatenate([scale(a.col_scale, a.n_cols)[:y.shape[0]],
                              np.pad(scale(h.col_scale, h.n_cols),
                                     (0, max(0, rem.shape[0] - h.n_cols)))])
        rs = scale(a.row_scale, a.n_tile_rows * 4)
        rs = np.pad(rs, (0, a.n_tile_rows * 4 - rs.size))
        vals = (rs[rows] * col[cols]).astype(np.float32)
        operand = torch.cat([y, rem])
        want = fl.agg_fp_pair(a, h, y, rem)
    else:
        operand = torch.cat([bitops.unpack_pm1(y, ho), bitops.unpack_pm1(rem, ho)])
        want = fl.agg_counts_pair(a, h, y, rem)[:, :ho].to(torch.float32)
    idx = torch.from_numpy(np.stack([rows, cols])).to(y.device)
    csr = torch.sparse_coo_tensor(
        idx, torch.from_numpy(vals).to(y.device),
        (a.n_tile_rows * 4, y.shape[0] + rem.shape[0])).coalesce() \
        .to_sparse_csr()
    got = torch.sparse.mm(csr, operand)[:a.n_rows]
    bad = (got - want).abs() > (0 if mag is None else
                                FP_TOL * mag + FP_TOL_ABS)
    if bool(bad.any()):
        raise AssertionError("pair yardstick: torch.sparse.mm differs from "
                             "the plain pair's sums")
    return ("torch.sparse.mm of [intra | halo] (scales in its values)"
            + (", +-1 float rows" if mag is None else ""),
            lambda: torch.sparse.mm(csr, operand))


def run_sharded(torch, flickr, single, params, art) -> tuple:
    """Phases 8-10: sharded serving on full Flickr, SHARDS shards on the
    one card, executor="host". Writes the graph and each way's sharded
    artifact under ``art`` (phase 18 restores them). Returns the records
    of the fused layer's sharded forms (rows 7e-7h), the store of the
    routed GCN "bin" session and each way's (pass logits, BN stats)."""
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
    t1 = time.perf_counter()
    np.savez(Path(art) / "graph.npz", name=flickr.name, x=flickr.x,
             y=flickr.y, edges=flickr.edges, n_classes=flickr.n_classes,
             train_mask=flickr.train_mask, val_mask=flickr.val_mask,
             test_mask=flickr.test_mask)
    for name, sess in sessions.items():
        sess.save(Path(art) / name.replace("/", "__"))
    phase8 = {name: (passes[name], [(mu.cpu().numpy(), sd.cpu().numpy())
                                    for mu, sd in sess.bn])
              for name, sess in sessions.items()}
    log(f"sharded artifacts of {len(sessions)} ways and the graph written: "
        f"{time.perf_counter() - t1:.1f} s")
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
    need = list(FORWARD_KERNELS) + ["fused_layer", "fused_pair"] \
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
    err["fused_pair"] = 0.0

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
    # the pair kernel alone on each step's transform: name -> (pair
    # arguments, keywords, sum of |terms| or None, bound, library call)
    pairs = {}

    def pair_case(args, **kw):
        y, ys, rem_, a_, h_, it_ = args
        words = y.dtype == torch.int32
        ho = kw["n_out"] if words else y.shape[1]
        nbytes = (group_bytes(a_) + group_bytes(h_) + 8 * it_.tasks.shape[0]
                  + y.element_size() * y.shape[1]
                  * (y.shape[0] + rem_.shape[0] + a_.n_rows))
        for scale in (a_.row_scale, a_.col_scale, h_.col_scale):
            nbytes += 0 if scale is None else 4 * scale.numel()
        if ys is not None:
            nbytes += 4 * ys.numel()
        mag = agg_mag = None
        if not words:
            mag = agg_mag = fl.agg_fp_pair(a_, h_, y.abs(), rem_.abs())
            if ys is not None:
                mag = agg_mag + ys.abs()
        return (args, kw, mag, bound(nbytes, [(
            2 * (a_.nnz + h_.nnz) * ho,
            INT8_TC_OPS_PER_S if words else FP32_OPS_PER_S)]),
            pair_library(torch, fl, a_, h_, y, rem_, ho, agg_mag))
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
        partial(fl.gcn_bin_l1, x, bn, w1, a, halo=h, rem=rem_w,
                pair_items=it, bn_rcp=True),
        partial(fl.gcn_bin_l1_plain, x, bn, w1, a, halo=h, rem=rem_w,
                bn_rcp=True),
        None, HIDDEN,
        bound(4 * npd * f_fl + 8 * f_fl + 4 * HIDDEN * (wk_f + 1) + adj_bytes
              + 4 * nhp * wh + 4 * npd * wh,
              [(2 * npd * f_fl * HIDDEN, FP32_OPS_PER_S),
               (2 * (a.nnz + h.nnz) * HIDDEN, INT8_TC_OPS_PER_S)]))
    pairs["gcn_bin_l1+halo"] = pair_case(
        (fl.transform(x, bn, w1, fbb=True, bn_rcp=True), None, rem_w, a, h,
         it), n_out=HIDDEN)
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
        partial(fl.gcn_bbf_fbf, x, bn, wf, a, True, None, h, rem, it, True),
        partial(fl.gcn_bbf_fbf_plain, x, bn, wf, a, True, h, rem, True),
        fl.agg_fp_pair(a, h, y.abs(), rem.abs()), None,
        bound(4 * npd * f_fl + 8 * f_fl + 4 * HIDDEN * (wk_f + 1)
              + group_bytes(a) + group_bytes(h) + 8 * (a.n_tile_rows + 1)
              + scale_bytes + 4 * h.n_cols * HIDDEN + 4 * npd * HIDDEN,
              [(2 * npd * HIDDEN * f_fl, INT8_TC_OPS_PER_S),
               (2 * npd * f_fl, FP32_OPS_PER_S),
               (2 * (a.nnz + h.nnz) * HIDDEN, FP32_OPS_PER_S)]))
    pairs["gcn_bbf_fbf+halo"] = pair_case(
        (fl.transform(x, bn, wf, bn_rcp=True), None, rem, a, h, it),
        relu=True)
    # GCN "bin" layer 2 (words 64 -> 7) with its pair: parity and step times
    a2, h2, it2 = shard0("gcn_bin/fused", "adj")
    hw = bitops.pack_bits(card(rng.integers(0, 2, (npd, HIDDEN))))
    w2 = weights(n_cls, HIDDEN)
    rem7 = ints((h2.n_cols, n_cls))
    y2 = fl._bbf(*fl._input(hw, None), w2)
    words_case = (
        partial(fl.gcn_bbf_fbf, hw, None, w2, a2, False, None, h2, rem7,
                it2),
        partial(fl.gcn_bbf_fbf_plain, hw, None, w2, a2, False, h2, rem7),
        fl.agg_fp_pair(a2, h2, y2.abs(), rem7.abs()))
    pairs["gcn_bbf_fbf+halo words"] = pair_case(
        (fl.transform(hw, None, w2), None, rem7, a2, h2, it2))
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
        partial(fl.branch_add, x, bn, ws, wa, a, True, None, h, rem, it, True),
        partial(fl.branch_add_plain, x, bn, ws, wa, a, True, h, rem, True),
        mag, None,
        bound(4 * npd * f_fl + 8 * f_fl + 8 * HIDDEN * (wk_f + 1)
              + group_bytes(a) + group_bytes(h) + 8 * (a.n_tile_rows + 1)
              + 4 * npd + 4 * h.n_cols * HIDDEN + 4 * npd * HIDDEN,
              [(4 * npd * HIDDEN * f_fl, INT8_TC_OPS_PER_S),
               (2 * npd * f_fl, FP32_OPS_PER_S),
               (2 * (a.nnz + h.nnz) * HIDDEN, FP32_OPS_PER_S)]))
    pairs["branch_add+halo"] = pair_case(
        (*fl.transform(x, bn, wa, bn_rcp=True, w_self=ws), rem, a, h, it),
        relu=True)
    # 7h: SAINT's fc, 64 -> 7, BN by the reciprocal (no aggregation): its
    # own launch (fused_fc), also held bit-exact against its mirror; the
    # yardstick a bf16 matmul of +-1 operands at its shapes, as row 7d's
    xh, bnh, wc = ints((npd, HIDDEN)), bn_of(HIDDEN), weights(n_cls, HIDDEN)
    wk_h = bitops.padded_words(HIDDEN)
    mirrors = {"fc+rcp": partial(fl.fc_rows_plain, xh, bnh, wc, bn_rcp=True)}
    a_fc = (2 * card(rng.integers(0, 2, (npd, HIDDEN))) - 1).to(torch.bfloat16)
    b_fc = (2 * card(rng.integers(0, 2, (HIDDEN, n_cls))) - 1).to(
        torch.bfloat16)
    libraries = {"fc+rcp": lambda: a_fc @ b_fc}
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
        if kind in mirrors:
            hold(f"fused_layer/{kind}", got, mirrors[kind]())
            cases += 1
    got = words_case[0]()
    hold("fused_layer/gcn_bbf_fbf+halo", got, words_case[0]())
    hold("fused_layer/gcn_bbf_fbf+halo", got, words_case[1](),
         magnitude=words_case[2])
    cases += 2
    for kind, (args, kw, mag, _, _) in pairs.items():
        got = fl.pair(*args, **kw)
        hold("fused_pair", got, fl.pair(*args, **kw))
        hold("fused_pair", got, fl.pair_plain(*args[:5], **kw),
             n_bits=kw.get("n_out"), magnitude=mag)
        cases += 2
    torch.cuda.synchronize()
    log(f"parity (sharded forms of the fused layer, and the pair kernel "
        f"alone on their transforms): {cases} cases passed; max abs err "
        + json.dumps(err))
    records = []
    for kind, (shape, call, plain, _, _, b) in specs.items():
        name = f"fused_layer/{kind}"
        lib = libraries.get(kind)
        records.append(kernel_record(
            name, shape, launches[name], err[name], cuda_ms(torch, call),
            cuda_ms(torch, plain, iters=5, warmup=1),
            cuda_ms(torch, lib) if lib is not None else None, b))
    log("device ms (torch.profiler), sharded forms at shard 0: " + json.dumps(
        {**{kind: device_ms(torch, call)
            for kind, (_, call, _, _, _, _) in specs.items()},
         **{f"{kind} library": device_ms(torch, lib)
            for kind, lib in libraries.items()}}))
    # the step (transform + pair launch) and the pair launch alone
    steps = {k: v[1] for k, v in specs.items() if k in pairs}
    steps["gcn_bbf_fbf+halo words"] = words_case[0]
    pair_times = {}
    for kind, (args, kw, _, b, (lib_name, lib)) in pairs.items():
        words = args[0].dtype == torch.int32
        call = partial(fl.pair, *args, **kw)
        pair_times[kind] = {
            "step_ms": cuda_ms(torch, steps[kind]),
            "step_device_ms": device_ms(torch, steps[kind]),
            "pair_ms": cuda_ms(torch, call),
            "pair_device_ms": device_ms(torch, call),
            "pair_bound_ms": b[0], "pair_bound_by": b[1],
            "library": lib_name, "library_ms": cuda_ms(torch, lib),
            "library_device_ms": device_ms(torch, lib),
            "attributes": fl.pair_attributes(
                kw.get("n_out") or args[0].shape[1], words)}
    log("time fused_pair per form at shard 0 (step = transform + pair): "
        + json.dumps(pair_times))
    args, kw, _, b, (_, lib) = pairs["gcn_bbf_fbf+halo"]
    records.append(kernel_record(
        "fused_pair", f"shard 0 GCN full layer 1's pair: {args[3].n_rows} "
        f"rows, rem {tuple(args[2].shape)}, {args[5].tasks.shape[0]} tasks "
        f"({args[5].n_part} of multi-item rows)", launches["fused_pair"],
        err["fused_pair"], pair_times["gcn_bbf_fbf+halo"]["pair_ms"],
        cuda_ms(torch, partial(fl.pair_plain, *args[:5], **kw), iters=5,
                warmup=1),
        pair_times["gcn_bbf_fbf+halo"]["library_ms"], b))
    log(f"phases 8-10: {time.perf_counter() - t_start:.1f} s")
    return records, store, phase8


def allreduce_1bit_plain(torch, bitops, grads):
    """The 1-bit all-reduce of ``grads`` (one a rank) on one process: the
    mean over ranks of each rank's sign * mean |g|."""
    n = grads[0].shape[0]
    rows = [bitops.unpack_pm1(bitops.pack_bits((g >= 0).reshape(1, -1)),
                              n)[0] * torch.mean(torch.abs(g))
            for g in grads]
    return torch.mean(torch.stack(rows), dim=0)


def spmd_rank(rank: int, art: str, device: str) -> dict:
    """One rank of phase 18 (a process of ``run_ranks``): restores every
    way's phase-8 artifact as an ``executor="spmd"`` session on ``device``
    and runs its full pass, the launch counts set to 0 just before and
    read just after; then the timed passes, the host executor over the
    mesh, distributed BN on both executors and the 1-bit all-reduce.
    Returns numpy and numbers."""
    import numpy as np
    import torch
    from repro_torch.core import bitops
    from repro_torch.distributed import collectives
    from repro_torch.graphs.datasets import GraphData
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_shard_mesh
    from repro_torch.models import gnn
    from repro_torch.quant.grad_compress import allreduce_1bit
    from repro_torch.serve import GraphStore
    from repro_torch.serve.sharded import ShardedGraphSession

    sync = torch.cuda.synchronize if device.startswith("cuda") \
        else (lambda: None)
    t0 = time.perf_counter()
    root = Path(art)
    g = np.load(root / "graph.npz")
    data = GraphData(name=str(g["name"]), x=g["x"], y=g["y"],
                     edges=g["edges"], n_classes=int(g["n_classes"]),
                     train_mask=g["train_mask"], val_mask=g["val_mask"],
                     test_mask=g["test_mask"])
    store = GraphStore(max_batch=SERVE_BATCH, khop=2, use_pallas=True,
                       device=device)
    store.register_graph("flickr", data)
    f, c = data.x.shape[1], data.n_classes
    for fam in ("gcn", "sage", "saint"):
        store.register_model(fam, fam, getattr(gnn, f"init_{fam}")(
            SEED, f, HIDDEN, c, device))

    def load(name, **kw):
        sess = ShardedGraphSession.load(
            root / name.replace("/", "__"), store.graphs["flickr"],
            store.models[SHARDED_WAYS[name][0]], khop=2,
            max_batch=SERVE_BATCH, use_pallas=True, device=device, **kw)
        if sess is None:
            raise AssertionError(f"phase 18 rank {rank}: the {name} "
                                 f"artifact did not restore")
        return sess

    sessions = {name: load(name, executor="spmd") for name in SHARDED_WAYS}
    setup_s = time.perf_counter() - t0
    # the main path: every way's full pass (calibration included)
    t1 = time.perf_counter()
    collectives.reset_staged()
    ops.reset_launch_counts()
    logits = {name: sess.full_logits() for name, sess in sessions.items()}
    sync()
    launches = ops.launch_counts()
    staged = collectives.staged_bytes()
    main_s = time.perf_counter() - t1
    out = dict(rank=rank, logits=logits, launches=launches,
               staged_bytes=staged, setup_s=setup_s, main_s=main_s)
    out["bn"] = {name: [(mu.cpu().numpy(), sd.cpu().numpy())
                        for mu, sd in sess.bn]
                 for name, sess in sessions.items()}
    out["compiles"] = {name: (sess.executor_compile_count, len(sess.program))
                       for name, sess in sessions.items()}
    out["halo"] = {}
    for name, sess in sessions.items():
        mp = sess.shard_plan.spmd_plan().mesh_plan
        out["halo"][name] = (dict(sess.halo_stats.bytes_by_tag), {
            st.tag: mp.payload_bytes(st.payload_cols, st.payload_itemsize)
            for st in sess.program if st.kind is not None})
    # each way's pass ms (host clock, median) and staged bytes a pass
    out["pass_ms"], out["staged_a_pass"] = {}, {}
    for name, sess in sessions.items():
        times = []
        for _ in range(SPMD_PASSES):
            t2 = time.perf_counter()
            sess.run_distributed_pass()
            sync()
            times.append((time.perf_counter() - t2) * 1e3)
        out["pass_ms"][name] = statistics.median(times)
        collectives.reset_staged()
        sess.run_distributed_pass()
        out["staged_a_pass"][name] = collectives.staged_bytes()
    # the host executor with its exchange over the mesh
    mesh = make_shard_mesh(SHARDS)
    host = load("gcn_bin/fused", mesh=mesh)
    out["mesh_host"] = (host.full_logits(), type(host.layer_executor).__name__,
                        host.layer_executor.mesh is mesh)
    # distributed BN, SPMD against the host executor (loopback, this rank)
    dh = load("sage/fused", bn_mode="distributed")
    ds = load("sage/fused", executor="spmd", bn_mode="distributed")
    dbn = []
    for sess in (dh, ds):
        dbn_logits = sess.full_logits()          # calibrates, then the pass
        dbn += [[(m.cpu().numpy(), sd.cpu().numpy()) for m, sd in sess.bn],
                dbn_logits]
    out["dbn"] = tuple(dbn)
    # the 1-bit all-reduce over the world against its plain version
    grads = [torch.from_numpy(np.random.default_rng(SEED + 100 + r)
                              .standard_normal(ALLREDUCE_N)
                              .astype(np.float32)).to(device)
             for r in range(SHARDS)]
    got = allreduce_1bit(grads[rank], mesh)
    want = allreduce_1bit_plain(torch, bitops, grads)
    out["allreduce"] = (float((got - want).abs().max()),
                        float(want.abs().max()), bool(torch.equal(got, want)))
    out["total_s"] = time.perf_counter() - t0
    return out


def run_spmd(torch, art, phase8) -> list:
    """Phase 18: the SPMD pass on the one card. ``run_ranks`` starts
    SHARDS gloo ranks on the card; each restores phase 8's artifacts
    (``spmd_rank``). Rank 0's full logits must equal phase 8's host
    executor's bit for bit, every rank's rank 0's, the host executor over
    the mesh too; distributed BN by the reference's rule; halo bytes the
    schedule's, programs one a step. Returns each rank's kernel
    launches."""
    import numpy as np

    t_start = time.perf_counter()
    device = f"{DEVICE}:0"
    ranks = world(spmd_rank, SHARDS, art, device, backend="gloo",
                  device=device, timeout_s=SPMD_TIMEOUT_S)
    wall_s = time.perf_counter() - t_start
    r0 = ranks[0]
    for name, (want, want_bn) in phase8.items():
        got = r0["logits"][name]
        if got.shape != want.shape or not np.isfinite(got).all():
            raise AssertionError(f"phase 18 {name}: logits {got.shape} not "
                                 f"finite of shape {want.shape}")
        if not np.array_equal(got, want):
            raise AssertionError(
                f"phase 18 {name}: rank 0's SPMD logits differ from phase "
                f"8's host executor (max |d| "
                f"{float(np.abs(got - want).max()):.3e})")
        if not all(np.array_equal(a, b) for ga, wa in zip(r0["bn"][name],
                                                           want_bn)
                   for a, b in zip(ga, wa)):
            raise AssertionError(f"phase 18 {name}: calibrations differ")
        for r in ranks:
            if not np.array_equal(r["logits"][name], got):
                raise AssertionError(f"phase 18 {name}: rank {r['rank']}'s "
                                     f"logits differ from rank 0's")
            compiles, steps = r["compiles"][name]
            if compiles != steps:
                raise AssertionError(f"phase 18 {name}: {compiles} programs "
                                     f"for {steps} steps")
            seen, sched = r["halo"][name]
            if seen != sched:
                raise AssertionError(f"phase 18 {name}: halo bytes {seen}, "
                                     f"the schedule's {sched}")
    mesh_logits, kind, same_mesh = r0["mesh_host"]
    if kind != "HostLayerExecutor" or not same_mesh or not all(
            np.array_equal(r["mesh_host"][0], mesh_logits) for r in ranks) \
            or not np.array_equal(mesh_logits, r0["logits"]["gcn_bin/fused"]):
        raise AssertionError("phase 18: the host executor over the mesh "
                             "differs from the SPMD pass")
    dbn_d = 0.0
    for r in ranks:
        h_bn, h_logits, s_bn, s_logits = r["dbn"]
        for (hm, hs), (sm, ss) in zip(h_bn, s_bn):
            for a, b in ((hm, sm), (hs, ss)):
                dbn_d = max(dbn_d, float(np.abs(a - b).max()))
                if not np.allclose(a, b, rtol=1e-5, atol=1e-5):
                    raise AssertionError("phase 18: distributed BN of the "
                                         "SPMD and host executors differ")
        if not np.array_equal(h_logits.argmax(1), s_logits.argmax(1)):
            raise AssertionError("phase 18: distributed BN predictions of "
                                 "the SPMD and host executors differ")
    for r in ranks:
        err, mag, _ = r["allreduce"]
        if err > 1e-6 * mag:
            raise AssertionError(f"phase 18: allreduce_1bit on rank "
                                 f"{r['rank']} off its plain version by "
                                 f"{err:.3e}")
    log("phase 18 SPMD pass, 4 gloo ranks on one card (not a deployment "
        "figure): " + json.dumps(dict(
            ways=list(phase8), bit_equal_to_phase_8=True,
            ranks_equal=True, mesh_host_equal=True,
            distributed_bn_max_abs_diff=dbn_d,
            allreduce_1bit=[dict(max_abs_err=r["allreduce"][0],
                                 bit_equal=r["allreduce"][2])
                            for r in ranks],
            halo_bytes_a_pass={n: r0["halo"][n][1] for n in phase8})))
    log("phase 18 per rank: " + json.dumps([dict(
        rank=r["rank"], pass_ms=r["pass_ms"],
        staged_bytes_a_pass=r["staged_a_pass"],
        staged_bytes_main=r["staged_bytes"], setup_s=r["setup_s"],
        main_s=r["main_s"], total_s=r["total_s"],
        launches={k: v for k, v in r["launches"].items() if v})
        for r in ranks]))
    log(f"phase 18: {time.perf_counter() - t_start:.1f} s (the world "
        f"{wall_s:.1f} s)")
    need = list(FORWARD_KERNELS) + ["fused_layer", "fused_pair"] \
        + [f"fused_layer/{k}" for k in PAIR_KINDS]
    for r in ranks:
        missing = [k for k in need if r["launches"].get(k, 0) == 0]
        if missing:
            raise AssertionError(f"phase 18 rank {r['rank']}: kernels never "
                                 f"launched: {missing}")
    return [r["launches"] for r in ranks]


def run_engine(torch, flickr, stores, sharded_store, single) -> dict:
    """Phases 11-12: the node-query engines on full Flickr, on the GCN
    stores of phase 6 and the sharded store of phase 8. Returns the kernel
    launches of the engine paths by kernel name."""
    import traceback

    import numpy as np
    from repro_torch.serve import (AdmissionController, GNNServeEngine,
                                   ShardedServeEngine, TenantPolicy)

    t_start = time.perf_counter()
    n_fl = flickr.n_nodes
    launches: dict = {}

    def counted(path, expect, fn):
        return drive(torch, launches, path, expect, fn)

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


def walk_fp(adj, x):
    """``ops.bspmm_fp`` on the CPU in the 1D ``bspmm_fp`` kernel's
    summation order (``bspmm_fp_walk_plain``): the column scale folded into
    x, the raw sums, the crop, the row scale."""
    from repro_torch.kernels import bspmm_kernel
    if adj.col_scale is not None:
        x = x * adj.col_scale[:, None].to(x.dtype)
    out = bspmm_kernel.bspmm_fp_walk_plain(adj, x)[: adj.n_rows]
    if adj.row_scale is not None:
        out = out * adj.row_scale[:, None].to(out.dtype)
    return out


def run_train(torch, flickr, adjs) -> dict:
    """Phase 13: train on full Flickr on the card, run the trained weights
    through the packed forwards and the fused serving path, and time the
    backends of Tables 3-5. ``adjs``: the FRDC adjacencies of phase 1 on
    the card. Returns the kernel launches of the trained forwards and the
    served batches by kernel name."""
    import math

    import numpy as np
    from repro_torch.core import bspmm as bspmm_core
    from repro_torch.kernels import ops
    from repro_torch.models import gnn
    from repro_torch.serve import GraphStore

    dev = DEVICE
    t_start = time.perf_counter()
    n_fl, f_fl = flickr.x.shape
    n_cls = flickr.n_classes
    x = torch.from_numpy(flickr.x).to(dev)
    # the precision the training and the Bi-GCN baseline multiply at: the
    # first layer's product on the card against float64 on the host, with
    # TF32 as set (off) and, for scale, on
    a = x[:4096]
    w1 = gnn.init_gcn(SEED, f_fl, HIDDEN, n_cls, dev).w1
    want = a.cpu().double() @ w1.cpu().double()
    err = {}
    for tf32 in (False, True):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        err[tf32] = float((a @ w1).cpu().double().sub(want).abs().max()
                          / want.abs().max())
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"phase 13 fp32 product vs float64: max |err| / max |ref| "
        f"{err[False]:.3e} (TF32 on: {err[True]:.3e}), limit {TF32_CHECK}")
    if err[False] > TF32_CHECK:
        raise AssertionError("phase 13: the card's fp32 product is not fp32")
    y = torch.from_numpy(flickr.y).long().to(dev)
    train_mask = torch.from_numpy(flickr.train_mask).to(dev)
    test_mask = torch.from_numpy(flickr.test_mask).to(dev)
    sparse = {k: gnn.sparse_adjacency(adjs[k])
              for k in ("gcn", "binary", "mean")}
    log(f"phase 13 sparse adjacencies: {time.perf_counter() - t_start:.1f} "
        f"s; nnz " + json.dumps({k: int(a.csr.values().numel())
                                 for k, a in sparse.items()}))

    # -- 13a. four models trained on the card -------------------------------
    trained, acc, train_log = {}, {}, {}
    for name, (fwd, fam, kinds, epochs, lr) in TRAIN.items():
        forward = getattr(gnn, fwd)
        inputs = (x, *[sparse[k] for k in kinds])
        p0 = getattr(gnn, f"init_{fam}")(SEED, f_fl, HIDDEN, n_cls, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, loss = gnn.train_node_classifier(forward, p0, inputs, y,
                                            train_mask, epochs=epochs, lr=lr)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if any(w.device != x.device for w in p) or not math.isfinite(loss):
            raise AssertionError(f"phase 13 {name}: weights on "
                                 f"{[w.device.type for w in p]}, loss {loss}")
        with torch.no_grad():
            acc[name] = gnn.accuracy(forward(p, *inputs), y, test_mask)
        trained[name] = p
        train_log[name] = dict(forward=fwd, epochs=epochs, lr=lr,
                               ms_a_step=wall * 1e3 / epochs, wall_s=wall,
                               final_loss=loss, test_acc=acc[name])
    log("phase 13 training: " + json.dumps(train_log))

    # -- 13b. the trained weights through the packed forwards ---------------
    packed = {"Ours(full)": (gnn.BitGCN(trained["Bi-GCN"], scheme="full"),
                             ("gcn", "binary")),
              "Ours(bin)": (gnn.BitGCN(trained["STE-bin"], scheme="bin"),
                            ("gcn", "binary")),
              "SAGE Ours": (gnn.BitSAGE(trained["SAGE Bi-GCN"]), ("mean",))}
    ops.reset_launch_counts()
    outs = {name: model(x, *[adjs[k] for k in kinds], return_bn_stats=True)
            for name, (model, kinds) in packed.items()}
    torch.cuda.synchronize()
    launches = {k: v for k, v in ops.launch_counts().items()
                if k in FORWARD_KERNELS}
    missing = [k for k in FORWARD_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"phase 13 packed forwards: kernels never "
                             f"launched: {missing}")
    for name, (model, kinds) in packed.items():
        logits, stats = outs[name]
        if tuple(logits.shape) != (n_fl, n_cls) \
                or not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"phase 13 {name}: logits not finite of "
                                 f"shape ({n_fl}, {n_cls})")
        cpu_stats = tuple((mu.cpu(), sd.cpu()) for mu, sd in stats)
        # the fp aggregation in the card's order: other orders give BN'd
        # values near 0 other signs, and trained weights differ each run
        with part("reference"), bspmm_core.override_backends(fp=walk_fp):
            want = model.to("cpu")(x.cpu(),
                                   *[adjs[k].to("cpu") for k in kinds],
                                   bn_stats=cpu_stats)
            model.to(dev)
        agree(f"phase 13 {name} vs the CPU", logits.cpu().numpy(),
              want.numpy())
        acc[name] = gnn.accuracy(logits, y, test_mask)
    # Ours(full) runs the Bi-GCN's function: its logits, not only its
    # accuracy, must agree, as the reference's test holds them
    with torch.no_grad():
        ref = gnn.gcn_forward_bigcn(trained["Bi-GCN"], x, sparse["gcn"])
    got = outs["Ours(full)"][0]
    off = ~torch.isclose(got, ref, rtol=FULL_VS_BIGCN, atol=FULL_VS_BIGCN)
    log(f"phase 13 Ours(full) vs Bi-GCN logits on the card: max |d| "
        f"{float((got - ref).abs().max()):.3e}, {int(off.sum())} of "
        f"{off.numel()} outside rtol = atol = {FULL_VS_BIGCN}")
    full_vs_bigcn = int(off.sum())   # raised at the end, after the timings
    cols = ("FP32", "Bi-GCN", "Ours(full)", "Ours(bin)", "SAGE Bi-GCN",
            "SAGE Ours")
    log("phase 13 test accuracy, full Flickr (STE-bin training forward "
        f"{acc['STE-bin']:.4f}); launches {json.dumps(launches)}")
    log("| " + " | ".join(cols) + " |")
    log("| " + " | ".join(f"{acc[c]:.4f}" for c in cols) + " |")
    if abs(acc["Ours(full)"] - acc["Bi-GCN"]) >= 0.04 \
            or acc["Ours(bin)"] < acc["STE-bin"] - 0.05 \
            or acc["SAGE Ours"] < acc["SAGE Bi-GCN"] - 0.06:
        raise AssertionError("phase 13: a packed forward lost the accuracy "
                             "of the training forward it runs")

    # -- 13c. the trained GCN "bin" served through the fused kernel ---------
    t0 = time.perf_counter()
    st = GraphStore(max_batch=SERVE_BATCH, khop=2, use_pallas=True,
                    fused=True, device=dev)
    st.register_graph("flickr", flickr)
    st.register_model("gcn", "gcn", trained["STE-bin"])
    sess = st.session("flickr", "gcn")
    sess.warmup(np.random.default_rng(SEED), probes=ENGINE_PROBES)
    programs = sess.compile_count
    seeds = np.random.default_rng(SEED + 7).integers(
        0, n_fl, size=(TRAIN_BATCHES, SERVE_BATCH))
    ops.reset_launch_counts()
    served, times = [], []
    for batch in seeds:
        t1 = time.perf_counter()
        served.append(sess.serve_subgraph(batch))
        times.append((time.perf_counter() - t1) * 1e3)
    counts = ops.launch_counts()
    others = {k: v for k, v in counts.items() if k != "fused_layer" and v}
    if counts["fused_layer"] != 2 * TRAIN_BATCHES or others:
        raise AssertionError(f"phase 13 serve: {counts}, want "
                             f"{2 * TRAIN_BATCHES} fused only")
    if sess.compile_count != programs:
        raise AssertionError(f"phase 13 serve: {sess.compile_count - programs}"
                             f" new programs after warmup")
    launches["fused_layer"] = counts["fused_layer"]
    agree("phase 13 served trained GCN vs the card's full-graph forward",
          np.concatenate(served), sess.full_logits()[seeds.reshape(-1)])
    log(f"phase 13 serve: {TRAIN_BATCHES} batches of {SERVE_BATCH}, p50 "
        f"{float(np.percentile(times, 50)):.3f} ms, launches "
        f"{json.dumps(counts)}; {time.perf_counter() - t0:.1f} s")

    # -- 13d. the backends of Tables 3-5 on the trained weights -------------
    edges = torch.from_numpy(np.concatenate(
        [flickr.edges, np.stack([np.arange(n_fl)] * 2)], axis=1)).to(dev)
    norm = 1.0 / torch.sqrt(torch.bincount(edges[0], minlength=n_fl)
                            .to(torch.float32) + 1.0)
    p_fp, p_bi, p_sage = (trained[k] for k in ("FP32", "Bi-GCN",
                                               "SAGE Bi-GCN"))
    q_full = gnn.quantize_gcn(p_bi)
    q_bin = gnn.quantize_gcn(trained["STE-bin"])
    q_sage = gnn.quantize_sage(p_sage)

    def fp32_scatter():
        h = x @ p_fp.w1
        h = gnn.aggregate_scatter(edges, h * norm[:, None], n_fl) \
            * norm[:, None]
        h2 = torch.relu(h) @ p_fp.w2
        return gnn.aggregate_scatter(edges, h2 * norm[:, None], n_fl) \
            * norm[:, None]

    tables = {
        "GCN": [
            ("FP32(S)", fp32_scatter),
            ("FP32(T)", lambda: gnn.gcn_forward_fp(p_fp, x, sparse["gcn"])),
            ("Bi-GCN", lambda: gnn.gcn_forward_bigcn(p_bi, x, sparse["gcn"])),
            ("Ours(full)", lambda: gnn.gcn_forward_bitgnn(
                q_full, x, adjs["gcn"], adjs["binary"], scheme="full")),
            ("Ours(bin)", lambda: gnn.gcn_forward_bitgnn(
                q_bin, x, adjs["gcn"], adjs["binary"], scheme="bin"))],
        "SAGE": [
            ("FP32(T)", lambda: gnn.sage_forward_fp(p_sage, x,
                                                    sparse["mean"])),
            ("Bi-GCN", lambda: gnn.sage_forward_bigcn(p_sage, x,
                                                      sparse["mean"])),
            ("Ours(bin)", lambda: gnn.sage_forward_bitgnn(q_sage, x,
                                                          adjs["mean"]))]}
    for table, rows in tables.items():
        out, base = {}, None
        for name, fn in rows:
            with torch.no_grad():
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn()
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                ms = cuda_ms(torch, fn)
            base = base or ms
            out[name] = dict(ms=ms, max_memory_allocated_mb=peak / 1e6,
                             added_by_forward_mb=(peak - resident) / 1e6,
                             speedup=base / ms)
        log(f"phase 13 times, {table} on full Flickr, trained weights "
            f"(speedup against {rows[0][0]}): " + json.dumps(out))
    log(f"phase 13: {time.perf_counter() - t_start:.1f} s")
    if full_vs_bigcn:
        raise AssertionError(f"phase 13: {full_vs_bigcn} Ours(full) logits "
                             f"outside {FULL_VS_BIGCN} of Bi-GCN's")
    return launches


def run_replica(torch, flickr, params) -> dict:
    """Phase 14: the replica tier on full Flickr at hidden 64, GCN "bin"
    with phase 6's seeded weights, BN calibrated by each store as in phase
    6. Returns the phase's kernel launches by kernel name."""
    import copy
    import tempfile

    import numpy as np
    from repro_torch.serve import (FaultInjector, FrontDoor, GraphStore,
                                   HealthPolicy, Resharder, SpanTracer,
                                   build_replica)

    t_start = time.perf_counter()
    n_fl = flickr.n_nodes
    models = {"gcn": ("gcn", params["gcn"])}
    launches: dict = {}
    rng = np.random.default_rng(SEED + 8)

    def nodes(n):
        return rng.integers(0, n_fl, size=n)

    def store(x=None, **kw):
        st = GraphStore(max_batch=SERVE_BATCH, khop=2, use_pallas=True,
                        device=DEVICE, **kw)
        st.register_graph("flickr", flickr if x is None
                          else dataclasses.replace(flickr, x=x))
        st.register_model("gcn", *models["gcn"])
        return st

    def replica(name, **kw):
        # a copy of the graph record: a feature update replaces the
        # replica's x, not the one the other phases share
        return build_replica(name, copy.copy(flickr), models,
                             graph="flickr", device=DEVICE,
                             max_batch=SERVE_BATCH, mode="subgraph",
                             retry_backoff_s=0.001, **kw)

    def answered(what, rqs):
        lost = [q.qid for q in rqs if not q.done]
        if lost:
            raise AssertionError(f"{what}: {len(lost)} of {len(rqs)} "
                                 f"queries unanswered")

    def p50_p99(rqs):
        lat = [q.latency_s * 1e3 for q in rqs]
        return float(np.percentile(lat, 50)), float(np.percentile(lat, 99))

    def cores(sess):
        return sess.cores if hasattr(sess, "cores") else [sess.core]

    def same_buckets(src, dst):
        """Give ``dst``'s serve cores the padded shapes ``src``'s serve at,
        so a replay launches the programs the engine launched."""
        for a, b in zip(cores(src), cores(dst)):
            b._n_water, b._g_water = a._n_water, dict(a._g_water)

    def replay(batches, sess):
        """(rows bit-equal, rows, engine answers, ``sess``'s answers) of
        every batch of ``batches`` served again on ``sess``."""
        got, want = [], []
        for batch in batches:
            want.append(np.asarray(sess.serve_subgraph(
                np.asarray([q.node for q in batch], np.int64))))
            got.append(np.stack([q.logits for q in batch]))
        got, want = np.concatenate(got), np.concatenate(want)
        return int((got == want).all(axis=1).sum()), len(got), got, want

    def bit_equal(what, batches, sess):
        eq, n, _, _ = replay(batches, sess)
        if eq != n:
            raise AssertionError(f"{what}: {n - eq} of {n} rows differ")
        return n

    def equal_or_agree(what, batches, sess):
        """Bit-equal, or else the rule of phase 3; says which held."""
        eq, n, got, want = replay(batches, sess)
        if eq != n:
            agree(what, got, want)
        return f"{eq} of {n} rows bit-equal" + ("" if eq == n else
                                                ", the rest by the rule")

    # -- 14a. failover ------------------------------------------------------
    t0 = time.perf_counter()
    faults = FaultInjector(seed=SEED)
    tracer = SpanTracer()
    reps = [replica(f"r{i}", store_kw=dict(khop=2, use_pallas=True,
                                           fused=True),
                    faults=faults, tracer=tracer, pipeline_depth=1)
            for i in range(2)]
    for r in reps:
        r.engine.warmup("flickr", "gcn", probes=ENGINE_PROBES)
    # the heartbeat deadline: half a warm batch's serve time, so shorter
    # than a tick; a monitor that checked a live replica before beating it
    # would fail it over (only r1 may go down)
    sess0 = reps[0].store.session("flickr", "gcn")
    probe = nodes(SERVE_BATCH)
    batch_ms = host_ms(torch, lambda: sess0.serve_subgraph(probe), iters=1)
    deadline_s = batch_ms / 2e3
    fd = FrontDoor(reps, faults=faults, tracer=tracer, spread="query",
                   policy=HealthPolicy(deadline_s=deadline_s))
    log(f"phase 14 tier: 2 fused replicas, warm batch {batch_ms:.1f} ms, "
        f"deadline {deadline_s * 1e3:.1f} ms; "
        f"{time.perf_counter() - t0:.1f} s")

    def failover():
        qs = fd.submit_many("flickr", "gcn", nodes(REPLICA_WAVE))
        # one tick: a batch answered on each replica, the next extracting
        # (two would answer the whole wave, and nothing would fail over)
        fd.tick()
        compiles = reps[0].engine.compile_count
        t_kill = time.perf_counter()
        faults.kill("r1")
        time.sleep(deadline_s)           # let the deadline lapse
        fd.run_until_drained()
        return qs, compiles, t_kill

    t0 = time.perf_counter()
    (wave, compiles, t_kill), counts = drive(
        torch, launches, "replica failover", ("fused_layer",), failover)
    answered("failover wave", wave)
    moved = [q for q in wave if q.failovers]
    down = [w.attrs["replica"] for w in tracer.warning_events()
            if w.name == "replica_unhealthy"]
    kinds = {w.name for w in tracer.warning_events()}
    if fd.pending or fd.failovers != 1 or not fd.failover_queries \
            or not moved or {q.replica for q in moved} != {"r0"} \
            or down != ["r1"] or not {"replica_unhealthy",
                                      "failover"} <= kinds:
        raise AssertionError(f"failover: {fd.snapshot()}, down {down}")
    if reps[0].engine.compile_count != compiles:
        raise AssertionError(f"failover: the survivor's programs "
                             f"{compiles} -> {reps[0].engine.compile_count}")
    # no program after warmup: each replica served every batch at the
    # buckets it has now, which its replay copies
    kill_ms = (max(q.inner.t_done for q in moved) - t_kill) * 1e3
    wave_p50, wave_p99 = p50_p99(wave)

    def readmit():
        faults.revive("r1")
        for _ in range(4):               # recovery_beats good beats
            fd.tick()
        qs = fd.submit_many("flickr", "gcn", nodes(REPLICA_QUERIES))
        fd.run_until_drained()
        return qs

    later, _ = drive(torch, launches, "replica readmission",
                     ("fused_layer",), readmit)
    answered("after readmission", later)
    if not fd.health.healthy("r1") or fd.readmissions != 1 \
            or {q.replica for q in later} != {"r0", "r1"}:
        raise AssertionError(f"readmission: {fd.snapshot()}")
    programs = [r.engine.recompile_watchdog.steady_recompiles for r in reps]
    if any(programs):
        raise AssertionError(f"failover: programs after warmup {programs}")
    ref = store(fused=True).session("flickr", "gcn")
    rows = 0
    for r in reps:
        same_buckets(r.store.session("flickr", "gcn"), ref)
        rows += bit_equal(f"failover replay of {r.name}", r.engine.batch_log,
                          ref)
    log("phase 14a failover: " + json.dumps(dict(
        wave=len(wave), wave_p50_ms=wave_p50, wave_p99_ms=wave_p99,
        moved=fd.failover_queries, kill_to_last_moved_ms=kill_ms,
        readmissions=fd.readmissions, launches=counts))
        + f"; {rows} rows of both replicas' batch_log bit-equal on a "
        f"single-host card session; {time.perf_counter() - t0:.1f} s")

    # -- 14b. version pinning -----------------------------------------------
    t0 = time.perf_counter()
    v0 = fd.snapshot()["versions"]["flickr"]
    logged = [len(r.engine.batch_log) for r in reps]
    changed = rng.choice(n_fl, size=n_fl // 100, replace=False)
    x_new = flickr.x.copy()
    x_new[changed] = rng.standard_normal(
        (changed.size, x_new.shape[1])).astype(np.float32)

    def pinning():
        t_update = time.perf_counter()
        fd.update_features("flickr", x_new)
        qs = fd.submit_many("flickr", "gcn", nodes(REPLICA_QUERIES))
        fd.run_until_drained()
        return qs, t_update

    (pinned, t_update), _ = drive(torch, launches, "version pinning",
                                  ("fused_layer",), pinning)
    answered("after the update", pinned)
    early = [q for q in wave + later
             if q.pinned_version != v0 or q.inner.t_done > t_update]
    if early or any(q.pinned_version != v0 + 1 for q in pinned):
        raise AssertionError(f"pinning: {len(early)} queries pinned before "
                             f"the update answered after it")
    fresh = store(x=x_new, fused=True).session("flickr", "gcn")
    n_rows = eq_old = 0
    for r, n0 in zip(reps, logged):
        post = list(r.engine.batch_log)[n0:]
        same_buckets(r.store.session("flickr", "gcn"), fresh)
        n_rows += bit_equal(f"{r.name} after the update vs a session built "
                            f"on the new features", post, fresh)
        same_buckets(r.store.session("flickr", "gcn"), ref)
        eq_old += replay(post, ref)[0]
    log(f"phase 14b version pinning: {changed.size} rows changed, "
        f"{len(pinned)} queries pinned to v{v0 + 1}, {n_rows} rows "
        f"bit-equal on a session built on the new features "
        f"({n_rows - eq_old} differ from the old features' answers); "
        f"{time.perf_counter() - t0:.1f} s")
    for r in reps:
        r.engine.close()

    # -- 14c. live reshard P = 2 -> 4 ---------------------------------------
    t0 = time.perf_counter()
    tracer_c = SpanTracer()
    rep = replica("s0", n_shards=2, store_kw=dict(khop=2, use_pallas=True),
                  tracer=tracer_c)
    rep.engine.warmup("flickr", "gcn", probes=ROUTED_PROBES)
    old_engine = rep.engine
    fd_c = FrontDoor([rep], tracer=tracer_c, spread="query",
                     policy=HealthPolicy(deadline_s=deadline_s))
    log(f"phase 14c replica at P = 2: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        def reshard():
            steady = fd_c.submit_many("flickr", "gcn", nodes(REPLICA_QUERIES))
            fd_c.run_until_drained()
            pre = fd_c.submit_many("flickr", "gcn", nodes(REPLICA_QUERIES))
            rs = Resharder(rep, "flickr", "gcn", 4, artifact_dir=tmp,
                           tracer=tracer_c)
            rs.prepare(block=False)
            during = 0
            while not rs.ready:          # the old engine serves the wave
                n = fd_c.tick()
                during += n
                if not n:
                    time.sleep(0.005)
            # queries queued on the old engine across the swap, which its
            # drain answers on P = 2
            cross = fd_c.submit_many("flickr", "gcn", nodes(SERVE_BATCH))
            report = rs.swap()
            post = fd_c.submit_many("flickr", "gcn", nodes(REPLICA_QUERIES))
            fd_c.run_until_drained()
            return steady, pre + cross, post, report, during

        t0 = time.perf_counter()
        (steady, pre, post, report, during), counts = drive(
            torch, launches, "live reshard", FORWARD_KERNELS, reshard)
        sidecar = Path(tmp) / "flickr__gcn__P2" / "routing.json"
        has_sidecar = sidecar.is_file()
    answered("reshard", steady + pre + post)
    phases = [w.attrs.get("phase") for w in tracer_c.warning_events()
              if w.name == "reshard"]
    if report.drain.shed or report.drain.answered != SERVE_BATCH \
            or fd_c.pending or report.from_shards != 2 \
            or rep.engine is old_engine or rep.engine.n_shards != 4 \
            or not has_sidecar \
            or phases != ["prepared", "swap_begin", "swap_end"]:
        raise AssertionError(f"reshard: {report.to_json()}, phases "
                             f"{phases}, routing.json {has_sidecar}")
    steady_p99 = p50_p99(steady)[1]
    blip_p99 = p50_p99(pre + post)[1]
    blip_bound = max(5.0 * steady_p99, 1000.0)
    # both sides against a freshly built P = 4 stack serving at the new
    # engine's buckets, and against the single-host session at the node cap
    fresh = store()
    fresh_p4 = fresh.sharded_session("flickr", "gcn", 4)
    same_buckets(rep.store.sharded_session("flickr", "gcn", 4), fresh_p4)
    single = fresh.session("flickr", "gcn")
    single.core.preset_water(single.core.node_cap, {}, 1.0)
    new_rows = bit_equal("new engine vs a fresh P = 4 stack",
                         rep.engine.batch_log, fresh_p4)
    checks = {
        "old engine vs a fresh P = 4 stack": equal_or_agree(
            "old engine vs a fresh P = 4 stack", old_engine.batch_log,
            fresh_p4),
        "new engine vs a fresh P = 4 stack": f"{new_rows} rows bit-equal",
        "old engine vs single-host": equal_or_agree(
            "old engine vs single-host", old_engine.batch_log, single),
        "new engine vs single-host": equal_or_agree(
            "new engine vs single-host", rep.engine.batch_log, single)}
    rep.engine.close()
    log("phase 14c live reshard: " + json.dumps(dict(
        prepare_s=report.prepare_s, swap_s=report.swap_s,
        drain=report.drain.to_json(), answered_while_building=during,
        steady_p99_ms=steady_p99, blip_p99_ms=blip_p99,
        blip_bound_ms=blip_bound, blip_within=blip_p99 < blip_bound,
        launches=counts)) + "; " + json.dumps(checks)
        + f"; {time.perf_counter() - t0:.1f} s")
    log("phase 14 launches: " + json.dumps(launches))
    log(f"phase 14: {time.perf_counter() - t_start:.1f} s")
    return launches


def token_config(name: str):
    """Phase 15's configuration of arch ``name``: the registry's, at full
    width, resolved for one device."""
    from repro_torch.configs import get_config
    return get_config(name).resolve_for_mesh(tp=1)


def depth_cut(name: str) -> tuple:
    """(``token_config(name)`` cut in depth as TOKEN_DEPTH says, 2 layers
    where it names no cut; the cut as {field: "full -> cut"}). The width
    stays the registry's."""
    full = token_config(name)
    cut = TOKEN_DEPTH.get(name, dict(n_layers=2))
    return (dataclasses.replace(full, **cut),
            {k: f"{getattr(full, k)} -> {v}" for k, v in cut.items()})


def stepwise(torch, cfg, params, prompts, max_news, batch, cache_len):
    """Phase 15's ground truth for one served batch: a Python loop of
    ``decode_step`` at the session's ``batch`` and ``cache_len``, each slot
    fed its prompt token while it lasts and then its previous argmax (the
    reference's direct loop, at the served shapes, its feedback kept on
    the card). Returns each request's ``max_new`` generated tokens."""
    import numpy as np
    from repro_torch.models import transformer
    lens = [int(p.size) for p in prompts]
    steps = max(n + int(m) for n, m in zip(lens, max_news)) - 1
    grid = np.zeros((batch, steps), np.int32)
    for i, p in enumerate(prompts):
        grid[i, :p.size] = p[:steps]
    grid = torch.from_numpy(grid).to(DEVICE)
    fed = torch.tensor(lens + [0] * (batch - len(lens)), device=DEVICE)
    cache = transformer.init_cache(cfg, batch, cache_len, device=DEVICE)
    prev = torch.zeros(batch, dtype=torch.int32, device=DEVICE)
    gens = []
    for t in range(steps):
        tok = torch.where(t < fed, grid[:, t], prev)
        logits, cache = transformer.decode_step(params, cfg, cache,
                                                tok[:, None], t)
        prev = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1).to(torch.int32)
        gens.append(prev)
    gens = torch.stack(gens, dim=1).cpu().numpy()
    return [gens[i, n - 1:n - 1 + int(m)]
            for i, (n, m) in enumerate(zip(lens, max_news))]


@timing
def chunk_timing(torch, session, prompts) -> dict:
    """ms a decode step of one chunk launch of ``session`` at its batch
    and water: on the host clock (launch to synchronize) and on CUDA
    events (median of 3), and the device's busy ms and its kernels and
    memsets over one such chunk (torch.profiler) beside the host ms of
    that chunk, whose difference is the time the card idles; with the
    aten calls a step and the six aten ops of most self host time in the
    profiled chunk ([ms, calls]; the profiler slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    prepared = session.prepare_batch(prompts, [TOKEN_CHUNK] * len(prompts))
    staged = prepared.groups[0].staged
    core = session.core

    def chunk():
        state = core.adapter.init_state(core.max_batch, prepared.cache_len,
                                        device=DEVICE)
        return core.launch(staged, state)

    host, events = [], []
    chunk()
    torch.cuda.synchronize()
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        chunk()
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        events.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        chunk()
        torch.cuda.synchronize()
    busy, n_dev, host_ops = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += (e.device_time_total if hasattr(e, "device_time_total")
                     else e.cuda_time_total)
            n_dev += e.count
        elif e.key.startswith("aten::"):
            host_ops.append((e.self_cpu_time_total, e.key, e.count))
    host_ms, ev_ms = statistics.median(host), statistics.median(events)
    busy_ms = busy / 1e3
    top = sorted(host_ops, reverse=True)[:6]
    return dict(host_ms_per_step=host_ms / TOKEN_CHUNK,
                event_ms_per_step=ev_ms / TOKEN_CHUNK,
                device_ops_per_step=n_dev / TOKEN_CHUNK,
                aten_calls_per_step=sum(c for _, _, c in host_ops)
                / TOKEN_CHUNK,
                top_host_ops_profiled={k: [round(t / 1e3, 3), c]
                                       for t, k, c in top},
                device_busy_ms_per_chunk=busy_ms,
                host_ms_per_chunk=host_ms,
                idle_share=(max(0.0, 1.0 - busy_ms / host_ms)
                            if busy_ms > 0 else None))


def run_token(torch) -> None:
    """Phase 15: the token tier on the card (see the module docstring).
    Launches none of the GNN kernels; a failed check raises."""
    import numpy as np
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer
    from repro_torch.quant.binary_linear import quantized_param_bytes
    from repro_torch.serve import TokenServeEngine, TokenSession, TokenStore

    t_start = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(to_cpu(v) for v in tree)
        return tree.cpu()

    def pct(xs):
        return (float(np.percentile(xs, 50)), float(np.percentile(xs, 99)))

    # -- 15a. stablelm-1.6b, served fp and packed ---------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, cut = depth_cut("stablelm-1.6b")
    params = transformer.init_params(cfg, gen, DEVICE)
    store = TokenStore(max_batch=TOKEN_BATCH, max_len=TOKEN_MAX_LEN,
                       chunk=TOKEN_CHUNK, warm_len=128, warm_new=16,
                       device=DEVICE)
    store.register_model("fp", cfg, params)
    store.register_model("bin", cfg, params, quantize=True)
    rng = np.random.default_rng(SEED + 9)
    lens = rng.integers(8, 129, TOKEN_REQUESTS)
    news = rng.integers(16, 65, TOKEN_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
               for n in lens]
    log(f"phase 15a stablelm-1.6b: {cfg.n_layers} layers (cut "
        f"{json.dumps(cut)}), d {cfg.d_model}, vocab {cfg.vocab}, params "
        f"{time.perf_counter() - t0:.1f} s")
    for name in ("fp", "bin"):
        t1 = time.perf_counter()
        eng = TokenServeEngine(store, pipeline_depth=1)
        warm = eng.warmup(name, probes=1)
        c0 = eng.compile_count
        t2 = time.perf_counter()
        qs = [eng.submit(name, p, max_new=int(m))
              for p, m in zip(prompts, news)]
        eng.run_until_drained()
        wall = time.perf_counter() - t2
        eng.close()
        steady = eng.snapshot()["watchdogs"]["recompile"]["steady_recompiles"]
        if not all(q.done and q.t_first_token > 0.0 for q in qs) \
                or eng.compile_count != c0 or steady:
            raise AssertionError(
                f"phase 15a {name}: {sum(q.done for q in qs)} of {len(qs)} "
                f"answered, {eng.compile_count - c0} new programs, "
                f"{steady} steady recompiles")
        sess = store.session(name)
        cache_len = sess.core._n_water
        for batch in eng.batch_log:
            with part("reference"):
                want = stepwise(torch, cfg, sess.core.qparams,
                                [q.prompt for q in batch],
                                [q.max_new for q in batch], TOKEN_BATCH,
                                cache_len)
            for q, w in zip(batch, want):
                if not np.array_equal(q.tokens, w):
                    raise AssertionError(
                        f"phase 15a {name}: query {q.qid} differs from the "
                        f"stepwise loop at batch {TOKEN_BATCH}, cache "
                        f"{cache_len}")
        n_tok = sum(len(q.tokens) for q in qs)
        ttft = pct([q.ttft_s * 1e3 for q in qs])
        timing = chunk_timing(torch, sess, prompts[:TOKEN_BATCH])
        log(f"phase 15a stablelm-1.6b {name}: " + json.dumps(dict(
            warmup_programs=warm, new_programs_after_warmup=0,
            batches=len(eng.batch_log), cache_len=cache_len,
            generated_tokens=n_tok, serve_s=wall, tokens_per_s=n_tok / wall,
            ttft_ms_p50=ttft[0], ttft_ms_p99=ttft[1],
            param_bytes=quantized_param_bytes(sess.core.qparams),
            stepwise="every stream bit-equal", **timing))
            + f"; {time.perf_counter() - t1:.1f} s")

    # the launch stage inside the strict guard: a depth-1 drain of one batch
    class Guarded(TokenServeEngine):
        def _launch_stage(self, inf):
            with self.transfer_watchdog.strict_guard():
                super()._launch_stage(inf)

    guarded = Guarded(store, pipeline_depth=1, max_retries=1,
                      retry_backoff_s=0.0)
    gq = [guarded.submit("fp", p[:16], max_new=16)
          for p in prompts[:TOKEN_BATCH]]
    guarded.run_until_drained()
    guarded.close()
    wd = guarded.transfer_watchdog.snapshot()
    if wd["host_sync_in_launch"] or not all(q.done for q in gq):
        raise AssertionError(f"phase 15a strict guard: {wd}, "
                             f"{sum(q.done for q in gq)} answered")
    log("phase 15a strict guard, depth 1: " + json.dumps(wd))

    # one sequence's logits on the card against the CPU, same path
    seq = np.concatenate([prompts[0], qs[0].tokens])[:TOKEN_CHUNK]
    toks = torch.from_numpy(seq[None].astype(np.int64))
    card, _ = transformer.decode_chunk(
        params, cfg, transformer.init_cache(cfg, 1, 64, device=DEVICE),
        toks.to(DEVICE), 0)
    with part("reference"):
        cpu, _ = transformer.decode_chunk(
            to_cpu(params), cfg,
            transformer.init_cache(cfg, 1, 64, device="cpu"), toks, 0)
    card, cpu = card.float().cpu().numpy(), cpu.float().numpy()
    if not np.allclose(card, cpu, rtol=TOKEN_TOL, atol=TOKEN_TOL):
        raise AssertionError(f"phase 15a logits card vs CPU: max |d| "
                             f"{np.abs(card - cpu).max()}")
    log(f"phase 15a fp logits, {TOKEN_CHUNK} teacher-forced steps, card vs "
        f"CPU: max |d| "
        f"{float(np.abs(card - cpu).max())} (rule rtol = atol = {TOKEN_TOL}); "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    del params, store, eng, guarded, sess
    torch.cuda.empty_cache()

    # -- 15b. rwkv6-3b through TokenSession.run -----------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, cut = depth_cut("rwkv6-3b")
    params = transformer.init_params(cfg, gen, DEVICE)
    r_prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32)
                 for n in rng.integers(8, 33, TOKEN_BATCH)]
    r_news = [16] * TOKEN_BATCH
    for quant in (False, True):
        t1 = time.perf_counter()
        sess = TokenSession("rwkv", cfg, params, max_batch=TOKEN_BATCH,
                            max_len=TOKEN_MAX_LEN, chunk=TOKEN_CHUNK,
                            quantize=quant, device=DEVICE)
        t2 = time.perf_counter()
        outs = sess.run(r_prompts, r_news)
        wall = time.perf_counter() - t2
        with part("reference"):
            want = stepwise(torch, cfg, sess.core.qparams, r_prompts,
                            r_news, TOKEN_BATCH, sess.core._n_water)
        if not all(np.array_equal(o, w) for o, w in zip(outs, want)):
            raise AssertionError(f"phase 15b rwkv6-3b quantize={quant}: "
                                 f"streams differ from the stepwise loop")
        # decode_chunk against stepwise decode, logits and every cache leaf
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9))).to(DEVICE)
        c_s = transformer.init_cache(cfg, 2, 32, device=DEVICE)
        rows = []
        for i in range(toks.shape[1]):
            lg, c_s = transformer.decode_step(sess.core.qparams, cfg, c_s,
                                              toks[:, i:i + 1], i)
            rows.append(lg[:, 0])
        got, c_c = transformer.decode_chunk(
            sess.core.qparams, cfg,
            transformer.init_cache(cfg, 2, 32, device=DEVICE), toks, 0)
        leaves_s = transformer.cache_to_numpy(c_s)["layers"]
        leaves_c = transformer.cache_to_numpy(c_c)["layers"]
        if not torch.equal(got, torch.stack(rows, dim=1)) or any(
                not np.array_equal(a[k], b[k])
                for a, b in zip(leaves_s, leaves_c) for k in a):
            raise AssertionError(f"phase 15b rwkv6-3b quantize={quant}: "
                                 f"decode_chunk differs from stepwise")
        n_tok = sum(len(o) for o in outs)
        timing = chunk_timing(torch, sess, r_prompts)
        log(f"phase 15b rwkv6-3b quantize={quant}: " + json.dumps(dict(
            layers=cfg.n_layers, cut=cut, d_model=cfg.d_model,
            cache_len=sess.core._n_water, generated_tokens=n_tok,
            run_s=wall, tokens_per_s=n_tok / wall,
            param_bytes=quantized_param_bytes(sess.core.qparams),
            stepwise="every stream bit-equal",
            decode_chunk="bit-equal to stepwise, logits and cache leaves",
            **timing)) + f"; {time.perf_counter() - t1:.1f} s")
        del sess
    log(f"phase 15b peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"{time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()

    # -- 15c. every arch at full width, cut in depth ------------------------
    t0 = time.perf_counter()
    cuts, rows = {}, {}
    for name in sorted(ARCHS):
        t1 = time.perf_counter()
        cfg, cuts[name] = depth_cut(name)
        torch.cuda.reset_peak_memory_stats()
        params = transformer.init_params(cfg, gen, DEVICE)
        b, t = 2, 8
        kw = {}
        t_text = t
        if cfg.family == "vlm":
            t_text = 4
            kw["image_embeds"] = torch.randn(
                (b, cfg.frontend_len, cfg.frontend_dim), generator=gen,
                device=DEVICE)
        if cfg.is_encdec:
            kw["frames"] = torch.randn(
                (b, cfg.frontend_len, cfg.frontend_dim), generator=gen,
                device=DEVICE)
        tokens = torch.randint(0, cfg.vocab, (b, t_text), generator=gen,
                               device=DEVICE)
        logits = transformer.forward(params, cfg, tokens, **kw).float()
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"phase 15c {name}: logits not finite")
        row = dict(shape=list(logits.shape))
        if cfg.family != "vlm":
            cache = transformer.init_cache(cfg, b, t + 4,
                                           enc_len=cfg.frontend_len,
                                           device=DEVICE)
            if cfg.is_encdec:
                cache["enc_memory"] = transformer._encode(
                    params, cfg, kw["frames"], q_chunk=0)
            for i in range(t):
                dec, cache = transformer.decode_step(
                    params, cfg, cache, tokens[:, i:i + 1], i)
            d = (dec[:, 0].float() - logits[:, -1]).abs()
            row["decode_vs_forward_max_abs"] = float(d.max())
            if not torch.allclose(dec[:, 0].float(), logits[:, -1],
                                  rtol=TOKEN_TOL, atol=TOKEN_TOL):
                raise AssertionError(f"phase 15c {name}: decode vs forward "
                                     f"max |d| {float(d.max())}")
        if cfg.family == "moe" and name == "qwen2-moe-a2.7b":
            runs = [transformer.decode_chunk(
                params, cfg, transformer.init_cache(cfg, b, 16,
                                                    device=DEVICE),
                tokens, 0)[0] for _ in range(2)]
            if not torch.equal(runs[0], runs[1]):
                raise AssertionError("phase 15c qwen2-moe-a2.7b: two "
                                     "decodes differ")
            row["two_decodes"] = "bit-equal"
        row["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        row["s"] = time.perf_counter() - t1
        rows[name] = row
        del params, logits
        torch.cuda.empty_cache()
    log("phase 15c reduced: " + json.dumps(cuts))
    log("phase 15c archs at full width: " + json.dumps(rows)
        + f"; {time.perf_counter() - t0:.1f} s")
    log(f"phase 15: {time.perf_counter() - t_start:.1f} s")


def lm_recipe(torch, cfg, device: str, opt_cls=None) -> tuple:
    """``launch/train.py``'s recipe for ``cfg`` on ``device``, as phase 16
    (a), 19 (b)'s ranks and 19 (b)'s reference run it: the optimizer
    (``opt_cls``, AdamW by default; cosine peak LM_LR over LM_STEPS,
    warmup 10, clip 1.0)'s train step, the seeded initial state and a
    maker of the synthetic loader."""
    from repro_torch.data.pipeline import PrefetchLoader, SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.optim.optimizer import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_train_step

    opt = (opt_cls or AdamW)(lr=cosine_schedule(LM_LR, 10, LM_STEPS),
                             clip_norm=1.0)
    step = make_train_step(cfg, opt, unroll=False)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(SEED)
        params = transformer.init_params(cfg, gen, device)
        return params, opt.init(params), ()

    def make_loader():
        return PrefetchLoader(SyntheticLM(cfg.vocab, LM_SEQ), LM_BATCH)
    return step, init_state, make_loader


def run_lm_train(torch) -> None:
    """Phase 16: LM training on the card (see the module docstring).
    Launches none of the GNN kernels; a failed check raises."""
    import shutil
    import tempfile

    import numpy as np
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.optim.optimizer import AdamW, tree_leaves
    from repro_torch.train.train_step import make_loss_fn, value_and_grad
    from repro_torch.train.trainer import (FailureInjector, Trainer,
                                           TrainerConfig, run_with_restarts)

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    # -- 16a. smollm-135m at full width through Trainer ---------------------
    cfg = token_config(LM_ARCH)
    rec = dict(losses=[], host_ms=[], event_ms=[], save_s=[], dtypes=None,
               update_ms=[])

    class TimedAdamW(AdamW):
        """The recipe's AdamW; in one steady step it also times the
        update alone (a synchronize before and after it)."""

        def update(self, grads, state, params):
            if not rec.get("split"):
                return super().update(grads, state, params)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().update(grads, state, params)
            torch.cuda.synchronize()
            rec["update_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

    step, init_state, make_loader = lm_recipe(torch, cfg, DEVICE,
                                              TimedAdamW)
    saved = {}

    def timed_step(params, opt_state, batch):
        n = len(rec["losses"])
        if n == LM_PROFILE_STEP and "profile" not in rec:
            return profiled_step(params, opt_state, batch)
        rec["split"] = n == LM_PROFILE_STEP + 1 and not rec["update_ms"]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        params, opt_state, metrics = step(params, opt_state, batch)
        end.record()
        rec["losses"].append(float(metrics["loss"]))   # syncs, as Trainer
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
        if rec["split"]:    # its update synchronized: left out of medians
            rec["split"] = False
            rec["split_step"] = dict(step_host_ms=host,
                                     update_host_ms=rec["update_ms"][-1])
            host = float("nan")
        rec["host_ms"].append(host)
        rec["event_ms"].append(start.elapsed_time(end))
        if rec["dtypes"] is None:     # after step 1
            rec["dtypes"] = sorted({str(x.dtype) for x in leaves(
                (params, opt_state.mu, opt_state.nu))})
        return params, opt_state, metrics

    def profiled_step(params, opt_state, batch):
        """One steady step under torch.profiler: the device's busy ms and
        launches (the profiler slows the host: this step is left out of
        the medians, and the idle share is taken against them)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, opt_state, metrics = step(params, opt_state, batch)
            rec["losses"].append(float(metrics["loss"]))
            torch.cuda.synchronize()
        busy, n_dev = 0.0, 0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                busy += (e.device_time_total
                         if hasattr(e, "device_time_total")
                         else e.cuda_time_total)
                n_dev += e.count
        rec["profile"] = dict(step=len(rec["losses"]),
                              device_busy_ms=busy / 1e3, device_ops=n_dev)
        rec["host_ms"].append(float("nan"))
        rec["event_ms"].append(float("nan"))
        return params, opt_state, metrics

    ckpt_dir = tempfile.mkdtemp(prefix="lm_ckpt_")
    loaders, restored = [], {}

    def make_trainer():
        loader = make_loader()
        loaders.append(loader)
        tr = Trainer(cfg, timed_step, init_state, loader, ckpt_dir,
                     TrainerConfig(total_steps=LM_STEPS,
                                   ckpt_every=LM_CKPT_EVERY, log_every=10),
                     failer=FailureInjector(LM_FAIL_AT if len(loaders) == 1
                                            else -1), device=DEVICE)
        save = tr.ckpt.save

        def recording_save(n, state, blocking=False):
            if n == LM_CKPT_EVERY:
                saved[n] = [x.clone() for x in leaves(state)]
            t0 = time.perf_counter()
            save(n, state, blocking)
            rec["save_s"].append((n, blocking, time.perf_counter() - t0))

        tr.ckpt.save = recording_save
        if len(loaders) == 2:          # the restore the resumed run makes
            t0 = time.perf_counter()
            *state, start = tr._fresh_or_restored()
            torch.cuda.synchronize()
            restored.update(s=time.perf_counter() - t0, start=start,
                            leaves=leaves(state))
        return tr

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = run_with_restarts(make_trainer, max_failures=1)
    finally:
        for loader in loaders:
            loader.close()
    train_s = time.perf_counter() - t0
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(x.numel() for x in leaves(init_state()[0]))
    ok_restore = (restored.get("start") == LM_CKPT_EVERY
                  and len(restored["leaves"]) == len(saved[LM_CKPT_EVERY])
                  and all(a.dtype == b.dtype and torch.equal(a, b) for a, b
                          in zip(restored["leaves"], saved[LM_CKPT_EVERY])))
    shutil.rmtree(ckpt_dir)
    losses = rec["losses"]
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    steady = [rec["host_ms"][i] for i in range(3, LM_FAIL_AT)
              if not np.isnan(rec["host_ms"][i])]
    steady_ev = [rec["event_ms"][i] for i in range(3, LM_FAIL_AT)
                 if not np.isnan(rec["host_ms"][i])]
    busy = rec["profile"]["device_busy_ms"]
    log(f"phase 16a {LM_ARCH}: " + json.dumps(dict(
        card=card, layers=cfg.n_layers, d_model=cfg.d_model, heads=[cfg.n_heads,
                                                         cfg.n_kv_heads],
        vocab=cfg.vocab, dtype=cfg.dtype, params=n_params, batch=LM_BATCH,
        seq=LM_SEQ, steps_run=len(losses), restarts=out["restarts"],
        resumed_steps=out["steps"], restored_at=restored.get("start"),
        restore_bit_equal=ok_restore, dtypes_after_step_1=rec["dtypes"],
        loss_first5=first, loss_last5=last, final_loss=out["final_loss"],
        ms_per_step_host=statistics.median(steady),
        ms_per_step_events=statistics.median(steady_ev),
        profiled_step=rec["profile"],
        idle_share=(max(0.0, 1.0 - busy / statistics.median(steady))
                    if busy else None),
        update_split=rec["split_step"],
        first_step_ms_host=rec["host_ms"][0],
        save_calls_s=rec["save_s"], restore_s=restored.get("s"),
        peak_gib=peak_a, train_s=train_s)))
    if not (out["restarts"] == 1
            and out["steps"] == LM_STEPS - LM_CKPT_EVERY
            and len(losses) == LM_FAIL_AT + LM_STEPS - LM_CKPT_EVERY):
        raise AssertionError(f"phase 16a: {out['restarts']} restarts, "
                             f"{out['steps']} resumed steps, {len(losses)} "
                             f"steps in all")
    if not ok_restore:
        raise AssertionError("phase 16a: the state restored at step "
                             f"{LM_CKPT_EVERY} differs from the one saved")
    if rec["dtypes"] != ["torch.float32"]:
        raise AssertionError(f"phase 16a: leaves after step 1 are "
                             f"{rec['dtypes']}, want float32 (the reference)")
    if not (np.isfinite(losses).all() and last < first - LM_DROP):
        raise AssertionError(f"phase 16a: loss {first:.4f} -> {last:.4f}, "
                             f"want a drop of more than {LM_DROP}")
    del saved[LM_CKPT_EVERY], restored["leaves"]
    torch.cuda.empty_cache()

    # -- 16b. one loss and gradient step of every block family --------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 16)
    cuts, rows = {}, {}
    for name in GRAD_ARCHS:
        t1 = time.perf_counter()
        gcfg, cuts[name] = depth_cut(name)
        torch.cuda.reset_peak_memory_stats()
        params = transformer.init_params(gcfg, gen, DEVICE)
        tokens = torch.randint(0, gcfg.vocab, (GRAD_B, GRAD_T), generator=gen,
                               device=DEVICE, dtype=torch.int32)
        batch = {"tokens": tokens,
                 "labels": torch.roll(tokens, -1, dims=1)}
        if gcfg.is_encdec:
            batch["frames"] = torch.randn(
                (GRAD_B, gcfg.frontend_len, gcfg.frontend_dim),
                generator=gen, device=DEVICE)
        loss, grads = value_and_grad(make_loss_fn(gcfg, unroll=True,
                                                  q_chunk=0))(params, batch)
        gnorm = float(torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                     for g in tree_leaves(grads))))
        rows[name] = dict(loss=float(loss), grad_norm=gnorm,
                          leaves=len(tree_leaves(grads)),
                          peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                          s=time.perf_counter() - t1)
        if not (np.isfinite(float(loss)) and np.isfinite(gnorm)
                and gnorm > 0):
            raise AssertionError(f"phase 16b {name}: loss {float(loss)}, "
                                 f"gradient norm {gnorm}")
        del params, grads
        torch.cuda.empty_cache()
    log("phase 16b reduced: " + json.dumps(cuts))
    log(f"phase 16b loss and gradient step, full width ({card}): "
        + json.dumps(rows) + f"; {time.perf_counter() - t0:.1f} s")

    # -- 16c. block_remat on (a)'s config, one step --------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = transformer.init_params(cfg, gen, DEVICE)
    sample = SyntheticLM(cfg.vocab, LM_SEQ).sample(
        np.random.default_rng(SEED), LM_BATCH)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in sample.items()}
    res = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, grads = value_and_grad(make_loss_fn(
            cfg, unroll=False, q_chunk=0, block_remat=remat))(params, batch)
        torch.cuda.synchronize()
        res[remat] = (loss, tree_leaves(grads),
                      (torch.cuda.max_memory_allocated() - base) / 2**30)
    rel = [float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))
           for a, b in zip(res[True][1], res[False][1])]
    n_equal = sum(torch.equal(a, b) for a, b in zip(res[True][1],
                                                    res[False][1]))
    log(f"phase 16c block_remat, {LM_ARCH}: " + json.dumps(dict(
        card=card, loss=float(res[False][0]),
        loss_bit_equal=bool(torch.equal(res[True][0], res[False][0])),
        grad_leaves=len(rel), grad_leaves_bit_equal=n_equal,
        grad_max_rel_diff=max(rel), tol=REMAT_TOL,
        peak_gib_above_params_plain=res[False][2],
        peak_gib_above_params_remat=res[True][2]))
        + f"; {time.perf_counter() - t0:.1f} s")
    if not torch.equal(res[True][0], res[False][0]) or max(rel) > REMAT_TOL:
        raise AssertionError(f"phase 16c: remat loss {float(res[True][0])} "
                             f"vs {float(res[False][0])}, grads max rel "
                             f"diff {max(rel)}")
    del params, res, grads
    torch.cuda.empty_cache()
    log(f"phase 16: {time.perf_counter() - t_start:.1f} s ({card})")


def run_dryrun(torch) -> None:
    """Phase 17: the dry run of the full configs, and its memory estimate
    held against the card (see the module docstring). Launches none of
    the GNN kernels; a failed check raises."""
    import contextlib
    import io

    import numpy as np
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.optim.optimizer import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_serve_step, make_train_step

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    total = torch.cuda.get_device_properties(0).total_memory

    # -- 17a. the full configs' cells through the launchers ------------------
    cells = {}
    for name, launcher, arch in (("train_4k", train_launcher, LM_ARCH),
                                 ("decode_32k", serve_launcher,
                                  DRY_SERVE_ARCH)):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            r = launcher.main(["--arch", arch, "--mesh", "single"])
        if json.loads(out.getvalue()) != r:
            raise AssertionError(f"phase 17a {arch}: the launcher printed "
                                 "another result than it returned")
        cells[name] = r
        mem = r["memory"]["per_device_hbm_bytes"]
        log(f"phase 17a {arch} {name} single ({card}): " + json.dumps(dict(
            n_devices=r["n_devices"], mode=r["mode"],
            per_device_hbm_bytes=mem, fits_card=mem <= total,
            card_total_memory=total, memory=r["memory"],
            flops_per_device=r["flops_per_device"],
            bytes_per_device=r["bytes_per_device"],
            collective_bytes_per_device=r["collective_bytes_per_device"],
            collectives_by_op=r["collectives_scanned_program"],
            lower_s=r["lower_s"], probe_s=r["probe_s"],
            total_s=time.perf_counter() - t0)))
        if not (r["n_devices"] == 256 and mem > 0
                and r["flops_per_device"] > 0
                and r["collective_bytes_per_device"] > 0):
            raise AssertionError(f"phase 17a {arch}: {r}")
    # the probes against the full trace on the train cell
    t0 = time.perf_counter()
    full = dryrun.run_cell(LM_ARCH, "train_4k", "single", probe=False)
    rel = {k: abs(cells["train_4k"][k] - full[k]) / full[k] for k in (
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device")}
    log(f"phase 17a {LM_ARCH} train_4k, probes against the full trace: "
        + json.dumps(dict(rel_diff=rel, full_s=time.perf_counter() - t0)))
    if max(rel.values()) > 1e-9:
        raise AssertionError(f"phase 17a: probes off the full trace {rel}")

    # -- 17b. the estimate on a 1 x 1 host mesh against the card -------------
    def measured(build, run):
        """Peak bytes allocated above what lived before ``build`` made
        the step's arguments, over one ``run`` of the step, twice from
        fresh arguments: the first may also allocate what the process
        then keeps (a thread's cuBLAS workspace)."""
        peaks = []
        for _ in range(2):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            args = build()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = run(*args)
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated() - base)
            del args, out
        torch.cuda.empty_cache()
        return peaks

    rows = {}
    opt = AdamW(lr=cosine_schedule(LM_LR, 10, LM_STEPS), clip_norm=1.0)
    plain = dict(remat=False, seq_shard=False, q_chunk=0, donate_cache=False)
    lm = token_config(LM_ARCH)
    sample = SyntheticLM(lm.vocab, LM_SEQ).sample(
        np.random.default_rng(SEED), LM_BATCH)

    def build_train():
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        params = transformer.init_params(lm, gen, DEVICE)
        batch = {k: torch.from_numpy(v).to(DEVICE)
                 for k, v in sample.items()}
        return params, opt.init(params), batch

    dec = token_config(DRY_SERVE_ARCH)
    b, s_len = DRY_DECODE

    def build_decode():
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        params = transformer.init_params(dec, gen, DEVICE)
        cache = transformer.init_cache(dec, b, s_len, device=DEVICE)
        tokens = torch.zeros((b, 1), dtype=torch.int32, device=DEVICE)
        return params, cache, tokens, s_len - 1

    for name, cfg, shape, build, step in (
            (f"{LM_ARCH} train {LM_BATCH}x{LM_SEQ}", lm,
             ShapeConfig("train", LM_SEQ, LM_BATCH, "train"), build_train,
             make_train_step(lm, opt, unroll=False)),
            (f"{DRY_SERVE_ARCH} decode {b}x1, cache {s_len}", dec,
             ShapeConfig("decode", s_len, b, "decode"), build_decode,
             make_serve_step(dec))):
        t0 = time.perf_counter()
        with make_host_mesh() as mesh:
            est = dryrun._trace_cell(cfg, shape, mesh, plain,
                                     unroll=shape.kind == "decode", opt=opt)
        trace_s = time.perf_counter() - t0
        first, second = measured(build, step)
        rows[name] = dict(estimate=int(est["peak"]),
                          measured_first=int(first),
                          measured_second=int(second),
                          ratio_first=est["peak"] / first,
                          ratio_second=est["peak"] / second,
                          argument=int(est["argument"]), trace_s=trace_s)
    ok = all(r["estimate"] >= (1 - DRY_UNDER) * max(r["measured_first"],
                                                    r["measured_second"])
             for r in rows.values())
    log(f"phase 17b estimate / measured peak bytes ({card}): "
        + json.dumps(rows))
    if not ok:
        raise AssertionError(f"phase 17b: an estimate sits more than "
                             f"{DRY_UNDER:.0%} below the measured peak: "
                             f"{rows}")
    moe = moe_placed_step(torch)
    log(f"phase 17b {EP_ARCH} train step under placements on 1 x 1 "
        f"({card}): " + json.dumps(moe))
    if moe["plain_loss"] != moe["placed_loss"]:
        raise AssertionError(f"phase 17b: the MoE step's loss under "
                             f"placements is not the plain step's: {moe}")
    log(f"phase 17: {time.perf_counter() - t_start:.1f} s ({card})")


def moe_placed_step(torch) -> dict:
    """Phase 17 (b)'s MoE step: one train step of ``EP_ARCH`` at full width
    cut to ``EP_LAYERS`` layers with global dispatch (``moe_groups=0``),
    from one seeded state and batch (``DRY_MOE``), on plain tensors and
    then under ``param_shardings(fsdp=True)`` on the 1 x 1 host mesh.
    Returns both losses (the caller holds them equal), each step's host
    ms and the bytes still allocated after both."""
    import contextlib
    import numpy as np
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint.checkpointer import _place
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.optim.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(token_config(EP_ARCH), n_layers=EP_LAYERS,
                              moe_groups=0)
    opt = AdamW(lr=LM_LR, clip_norm=1.0)
    step = make_train_step(cfg, opt, unroll=False)
    b, t = DRY_MOE
    sample = SyntheticLM(cfg.vocab, t).sample(np.random.default_rng(SEED), b)

    def one(mesh):
        gen = torch.Generator(device=DEVICE).manual_seed(SEED)
        params = transformer.init_params(cfg, gen, DEVICE)
        state = (params, opt.init(params))
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in sample.items()}
        if mesh is not None:
            p_sh = sharding.param_shardings(params, mesh, fsdp=True)
            state = place_tree(state, (p_sh, sharding.opt_shardings(p_sh,
                                                                     mesh)))
            batch = sharding.zip_map(lambda v, pl: _place(v, mesh, pl),
                                     batch, sharding.data_shardings(batch,
                                                                    mesh))
        sync(torch, DEVICE)
        t0 = time.perf_counter()
        with implicit_replication() if mesh is not None \
                else contextlib.nullcontext():
            _, _, metrics = step(*state, batch)
        loss = metrics["loss"]
        loss = loss.full_tensor() if hasattr(loss, "full_tensor") else loss
        loss = float(loss)
        sync(torch, DEVICE)
        return loss, (time.perf_counter() - t0) * 1e3

    on_card = DEVICE == "cuda"
    base = torch.cuda.memory_allocated() if on_card else 0
    plain_loss, plain_ms = one(None)
    with make_host_mesh(device=torch.device(DEVICE).type) as mesh:
        placed_loss, placed_ms = one(mesh)
    if on_card:     # phase 19's ranks share the card: return what was cached
        torch.cuda.empty_cache()
    return dict(layers=EP_LAYERS, batch=b, tokens=t, moe_groups=0,
                plain_loss=plain_loss, placed_loss=placed_loss,
                plain_ms=plain_ms, placed_ms=placed_ms,
                left_allocated=(torch.cuda.memory_allocated() - base
                                if on_card else 0))


def gather_probe_rank(rank: int, device: str) -> bool:
    """Phase 19's probe: DTensor's Shard -> Replicate (an all-gather) of a
    device tensor over gloo; the world dies if gloo cannot run it."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_host_mesh
    with make_host_mesh(model=1, device=torch.device(device).type) as mesh:
        x = torch.full((4, 8), float(rank), device=device)
        full = DTensor.from_local(x, mesh, [Shard(0), Replicate()]) \
            .full_tensor()
        return bool((full[4 * rank:4 * rank + 4] == rank).all())


def mesh_config(name: str, device: str):
    """Phase 19's configuration of ``name``: the registry's on the card,
    the reduced one elsewhere (a CPU rehearsal: the ranks are fresh
    processes, which no patch of this module reaches)."""
    if device.startswith("cuda"):
        return token_config(name)
    from repro_torch.configs import get_config, reduced_config
    return reduced_config(get_config(name)).resolve_for_mesh(tp=1)


def ep_config(device: str):
    """Phase 19 (a)'s model: EP_ARCH at full width, EP_LAYERS deep, fp32."""
    return dataclasses.replace(mesh_config(EP_ARCH, device),
                               n_layers=EP_LAYERS, dtype="float32")


def mesh_train_config(device: str):
    """Phase 19 (b)'s model: LM_ARCH at full width, MESH_LAYERS deep."""
    return dataclasses.replace(mesh_config(LM_ARCH, device),
                               n_layers=MESH_LAYERS)


def sync(torch, device: str) -> None:
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def expert_shardings(params, mesh):
    """Phase 19 (a)'s placements: each MoE block's experts sharded over
    ``model``, every other leaf replicated (the forward's only collective
    is then the MoE's all-reduce)."""
    from repro_torch.distributed import sharding

    def one(path, leaf):
        parts = path.split("/")
        expert = len(parts) > 1 and parts[-2] == "moe" \
            and parts[-1] in ("wi", "wo")
        spec = ("model",) + (None,) * (leaf.ndim - 1) if expert \
            else (None,) * leaf.ndim
        return mesh, sharding.placements(spec, mesh)
    return sharding._map_with_path(one, params)


def place_tree(tree, shardings):
    """Each leaf of ``tree`` as this rank's DTensor slice under the
    ``(mesh, placements)`` leaves of ``shardings``."""
    from repro_torch.checkpoint.checkpointer import (_flatten, _place,
                                                     _sharding_leaves,
                                                     _unflatten)
    return _unflatten(tree, [_place(v, *pl) for v, pl in zip(
        _flatten(tree)[1], _sharding_leaves(shardings))])


def median_host_ms(torch, device, fn, iters: int) -> float:
    out = []
    for _ in range(iters):
        sync(torch, device)
        t0 = time.perf_counter()
        fn()
        sync(torch, device)
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def peak_gib(torch, device: str) -> float:
    return torch.cuda.max_memory_allocated() / 2**30 \
        if device.startswith("cuda") else float("nan")


def ep_rank(rank: int, data: int, model: int, device: str) -> dict:
    """Phase 19 (a), one rank: the plain forward and gradient step on the
    card, then the same on the (data, model) mesh with
    ``moe_groups=-1``; returns the checks and timings of this rank."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.checkpoint.checkpointer import _place
    from repro_torch.distributed import sharding
    from repro_torch.distributed.hlo_analysis import CollectiveRecorder
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer
    from repro_torch.train.train_step import make_loss_fn, value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()
    cfg = ep_config(device)
    plain_cfg = dataclasses.replace(cfg, moe_groups=data if data > 1 else 0)
    mesh_cfg = dataclasses.replace(cfg, moe_groups=-1)
    gen = torch.Generator(device=device).manual_seed(SEED + 19)
    params = transformer.init_params(cfg, gen, device)
    tokens = torch.randint(0, cfg.vocab, (EP_B, EP_T), generator=gen,
                           device=device, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    e_loc = (cfg.moe_experts_padded or cfg.moe_experts) // model
    moe = [i for i, blk in enumerate(params["blocks"]) if "moe" in blk]
    out = {"rank": rank, "experts_here": e_loc}
    with make_host_mesh(model=model, device=torch.device(device).type) \
            as mesh:
        m, di = mesh.get_local_rank(1), mesh.get_local_rank(0)
        rows = slice(di * EP_B // data, (di + 1) * EP_B // data)
        with torch.no_grad():
            want = transformer.forward(params, plain_cfg, tokens,
                                       unroll=True)[rows]
        want_loss, grads = value_and_grad(make_loss_fn(
            plain_cfg, unroll=True, q_chunk=0))(params, batch)
        want_g = {(i, w): (grads["blocks"][i]["moe"][w][
            m * e_loc:(m + 1) * e_loc].clone(),
            float(grads["blocks"][i]["moe"][w].abs().max()))
            for i in moe for w in ("wi", "wo")}
        del grads
        placed = place_tree(params, expert_shardings(params, mesh))
        b = sharding.zip_map(lambda v, pl: _place(v, mesh, pl), batch,
                             sharding.data_shardings(batch, mesh))
        vg = value_and_grad(make_loss_fn(mesh_cfg, unroll=True, q_chunk=0))

        def forward():
            return transformer.forward(placed, mesh_cfg, b["tokens"],
                                       unroll=True)

        def step():
            loss, g = vg(placed, b)
            return loss, sharding.match_placements(g, placed)
        with implicit_replication():
            with CollectiveRecorder() as rec_f:
                logits = forward()
            with CollectiveRecorder() as rec_s:
                loss, g = step()
            got = logits.to_local()
            out["logit_max_abs_err"] = float((got - want).abs().max())
            out["logit_scale"] = float(want.abs().max())
            out["argmax_equal"] = bool(torch.equal(got.argmax(-1),
                                                   want.argmax(-1)))
            out["loss"] = float(loss.full_tensor())
            out["want_loss"] = float(want_loss)
            out["grad_rel_err"] = {
                f"{i}/{w}": float((g["blocks"][i]["moe"][w].to_local()
                                   - ref).abs().max()) / scale
                for (i, w), (ref, scale) in want_g.items()}
            out["grad_placements_kept"] = sharding.placements_of(g) \
                == sharding.placements_of(placed)
            out["forward_ms"] = median_host_ms(torch, device, forward, 3)
            out["step_ms"] = median_host_ms(torch, device, step, 1)
    fs, ss = rec_f.stats(), rec_s.stats()
    out.update(moe_layers=len(moe), forward_collectives=dict(
        fs.count_by_op), forward_bytes=dict(fs.bytes_by_op),
        step_collectives=dict(ss.count_by_op), step_bytes=dict(
            ss.bytes_by_op),
        peak_gib=peak_gib(torch, device), s=time.perf_counter() - t_start)
    return out


def mesh_train_rank(rank: int, ckpt_dir: str, fsdp: bool,
                    device: str) -> dict:
    """Phase 19 (b), one rank: 16a's recipe at MESH_LAYERS layers through
    ``run_with_restarts`` for MESH_STEPS steps, the restart restored under
    the placements of ``param_shardings(fsdp=fsdp)`` over (2, 1); the
    restarted loader skips the batches the first run took, so step s sees
    the one-process run's batch s."""
    import contextlib
    import hashlib

    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpointer
    from repro_torch.distributed import sharding
    from repro_torch.distributed.hlo_analysis import CollectiveRecorder
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.optimizer import tree_leaves
    from repro_torch.train.trainer import (FailureInjector, Trainer,
                                           TrainerConfig, run_with_restarts)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    cfg = mesh_train_config(device)
    step, init_state, make_loader = lm_recipe(torch, cfg, device)
    rec = dict(losses=[], host_ms=[], kept=[], meshed=[], coll=None,
               last=None, writes=[])
    real_savez = checkpointer.np.savez

    def savez(path, **arrays):
        rec["writes"].append(Path(path).parent.name)
        return real_savez(path, **arrays)
    checkpointer.np.savez = savez

    def timed(params, opt_state, batch):
        n = len(rec["losses"])
        steady = n == MESH_STEPS - 2
        sync(torch, device)
        t0 = time.perf_counter()
        with CollectiveRecorder() if steady else contextlib.nullcontext() \
                as coll:
            new = step(params, opt_state, batch)
        loss = new[2]["loss"]
        rec["losses"].append(float(loss.full_tensor()
                                   if hasattr(loss, "full_tensor") else loss))
        sync(torch, device)
        rec["host_ms"].append((time.perf_counter() - t0) * 1e3)
        if steady:
            rec["coll"] = coll.stats()
        rec["kept"].append(sharding.placements_of(new[:2])
                           == sharding.placements_of((params, opt_state)))
        rec["meshed"].append(any(type(x) is not torch.Tensor
                                 for x in tree_leaves(new[0])))
        rec["last"] = new[:2]
        return new

    loaders = []
    t_start = time.perf_counter()
    with make_host_mesh(model=1, device=torch.device(device).type) as mesh:
        failer = FailureInjector(MESH_FAIL_AT)

        def make():
            loader = make_loader()
            loaders.append(loader)
            if len(loaders) > 1:       # the batches of steps 0-3 again
                for _ in range(MESH_FAIL_AT):
                    loader.next_batch()
            p_sh = sharding.param_shardings(init_state()[0], mesh,
                                            fsdp=fsdp) \
                if len(loaders) > 1 else None
            shardings = None if p_sh is None else (
                p_sh, sharding.opt_shardings(p_sh, mesh), ())
            return Trainer(cfg, timed, init_state, loader, ckpt_dir,
                           TrainerConfig(total_steps=MESH_STEPS,
                                         ckpt_every=MESH_CKPT_EVERY,
                                         log_every=MESH_CKPT_EVERY),
                           failer=failer, shardings=shardings, device=device)
        try:
            res = run_with_restarts(make, max_failures=1)
        finally:
            for loader in loaders:
                loader.close()
            checkpointer.np.savez = real_savez
        digests = [hashlib.sha256(np.ascontiguousarray(
            checkpointer._host(x.full_tensor() if hasattr(x, "full_tensor")
                               else x)).tobytes()).hexdigest()
            for x in checkpointer._flatten((*rec["last"], ()))[1]]
        wq = [str(p) for p in sharding.placements_of(
            rec["last"][0])["blocks"][0]["attn"]["wq"] or []]
    return dict(rank=rank, losses=rec["losses"], host_ms=rec["host_ms"],
                kept=rec["kept"], meshed=rec["meshed"],
                restarts=res["restarts"],
                steps=res["steps"], writes=rec["writes"], digests=digests,
                wq_placements=wq, misses=res["straggler_misses"],
                coll_bytes=dict(rec["coll"].bytes_by_op) if rec["coll"]
                else {}, coll_count=dict(rec["coll"].count_by_op)
                if rec["coll"] else {},
                peak_gib=peak_gib(torch, device),
                s=time.perf_counter() - t_start)


def world2_rank(rank: int, ckpt_dir: str, fsdp: bool, device: str) -> dict:
    """Phase 19's world of two ranks: (a) on the first mesh of EP_MESHES,
    then (b); each part's checks are the parent's, on its own results."""
    data, model = EP_MESHES[0]
    return dict(ep=ep_rank(rank, data, model, device),
                train=mesh_train_rank(rank, ckpt_dir, fsdp, device))


def mesh_reference_losses(torch, device: str) -> list:
    """Phase 19 (b)'s reference: the MESH_STEPS losses of its recipe in
    this process, plain tensors, no failure (``Trainer`` as 16a runs it)."""
    import shutil

    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = mesh_train_config(device)
    step, init_state, make_loader = lm_recipe(torch, cfg, device)
    losses = []

    def recorded(params, opt_state, batch):
        new = step(params, opt_state, batch)
        losses.append(float(new[2]["loss"]))
        return new

    ckpt_dir = tempfile.mkdtemp(prefix="mesh_ref_")
    loader = make_loader()
    try:
        Trainer(cfg, recorded, init_state, loader, ckpt_dir,
                TrainerConfig(total_steps=MESH_STEPS,
                              ckpt_every=MESH_CKPT_EVERY,
                              log_every=MESH_CKPT_EVERY),
                device=device).run()
    finally:
        loader.close()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    return losses


def run_lm_mesh(torch) -> None:
    """Phase 19: the LM mesh paths on the one card (see the module
    docstring). Launches none of the GNN kernels; a failed check
    raises."""
    import hashlib
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from repro_torch.checkpoint.checkpointer import Checkpointer, _flatten
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models import transformer
    from repro_torch.optim.optimizer import AdamW

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    device = f"{DEVICE}:0" if DEVICE == "cuda" else DEVICE

    def probe():
        """Does DTensor's all-gather run on device tensors over gloo?"""
        try:
            return all(world(gather_probe_rank, 2, device, backend="gloo",
                             device=device, timeout_s=MESH_TIMEOUT_S)), \
                "DTensor's all-gather of device tensors runs over gloo"
        except RuntimeError as e:
            return False, ("DTensor's Shard -> Replicate (an all-gather) of "
                           "device tensors over gloo took the probe world "
                           "down (" + str(e).splitlines()[0] + ")")

    # -- 19c. the A3 dry-run cell, traced here while the probe's world runs
    def cell(groups):
        t0 = time.perf_counter()
        res = run_cell(EP_ARCH, "train_4k", "single", probe=False,
                       cfg_overrides={"moe_groups": groups})
        return dict(
            per_device_hbm_bytes=res["memory"]["per_device_hbm_bytes"],
            collective_bytes_per_device=res["collective_bytes_per_device"],
            collectives_by_op=res["collectives_scanned_program"],
            s=time.perf_counter() - t0)

    def hooks_left():
        """The cells' checkpointed blocks must leave no saved-tensor hooks
        behind (torch before 2.13 does where a block raises, unless
        models.transformer's _remat closes them): a later backward would
        recompute the block."""
        top = torch._C._autograd._top_saved_tensors_default_hooks
        try:
            return top(False) is not None
        except TypeError:
            return top() is not None

    with ThreadPoolExecutor(1) as pool:
        probed = pool.submit(probe)
        cells = {g: cell(g) for g in (-1, 0)}  # a failure fails the run
        if hooks_left():
            raise AssertionError("phase 19c: a cell left saved-tensor "
                                 "hooks installed")
        gather_ok, why = probed.result()
    log("phase 19 probe: " + json.dumps(dict(all_gather_ok=gather_ok,
                                              why=why)))
    log(f"phase 19c {EP_ARCH} train_4k single, moe_groups -1 (A3) and 0, "
        f"full depth, no probes: " + json.dumps(cells))

    # one world of two ranks runs (a) on EP_MESHES[0] and then (b), one of
    # four (a) on EP_MESHES[1] (four ranks of 18 GiB: this process holds
    # nothing more on the card than before the phase); then (b)'s
    # reference in this process
    kind = "fsdp" if gather_ok else "data-parallel"
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    ckpt_dir = tempfile.mkdtemp(prefix="mesh_ckpt_")
    try:
        t0 = time.perf_counter()
        two = world(world2_rank, 2, ckpt_dir, gather_ok, device,
                    backend="gloo", device=device, timeout_s=MESH_TIMEOUT_S)
        world2_s = time.perf_counter() - t0
        data, model = EP_MESHES[1]
        four = world(ep_rank, data * model, data, model, device,
                     backend="gloo", device=device, timeout_s=MESH_TIMEOUT_S)
        cfg = mesh_train_config(device)
        like_p = transformer.init_params(cfg, torch.Generator(), "meta")
        like = (like_p, AdamW().init(like_p), ())
        restored = _flatten(Checkpointer(ckpt_dir).restore(MESH_STEPS,
                                                           like))[1]
        digests = [hashlib.sha256(np.ascontiguousarray(v).tobytes())
                   .hexdigest() for v in restored]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    with part("reference"):
        want = mesh_reference_losses(torch, device)

    # -- 19a. expert-parallel MoE ------------------------------------------
    ep_rows = {}
    for (data, model), ranks in zip(EP_MESHES,
                                    ([r["ep"] for r in two], four)):
        key = f"({data}, {model})"
        for r in ranks:
            where = f"phase 19a {key} rank {r['rank']}"
            if not (r["logit_max_abs_err"]
                    <= EP_LOGIT_TOL * r["logit_scale"]
                    and r["argmax_equal"]):
                raise AssertionError(
                    f"{where}: logits off the plain forward by "
                    f"{r['logit_max_abs_err']:.3e} (scale "
                    f"{r['logit_scale']:.3e}), argmax equal "
                    f"{r['argmax_equal']}")
            if abs(r["loss"] - r["want_loss"]) > EP_LOSS_TOL * abs(
                    r["want_loss"]):
                raise AssertionError(f"{where}: loss {r['loss']} vs the "
                                     f"plain {r['want_loss']}")
            bad = {k: v for k, v in r["grad_rel_err"].items()
                   if not v <= EP_GRAD_TOL}
            if bad or not r["grad_placements_kept"]:
                raise AssertionError(f"{where}: expert gradients off by "
                                     f"{bad}, placements kept "
                                     f"{r['grad_placements_kept']}")
            if r["forward_collectives"].get("all-reduce") != r["moe_layers"]:
                raise AssertionError(
                    f"{where}: forward collectives "
                    f"{r['forward_collectives']}, want one all-reduce a "
                    f"MoE layer ({r['moe_layers']})")
        ep_rows[key] = [{k: r[k] for k in (
            "rank", "experts_here", "logit_max_abs_err", "logit_scale",
            "loss", "want_loss", "grad_rel_err", "forward_ms", "step_ms",
            "forward_collectives", "forward_bytes", "step_collectives",
            "step_bytes", "peak_gib", "s")} for r in ranks]
    log(f"phase 19a expert-parallel {EP_ARCH}, {EP_LAYERS} layers at full "
        f"width, fp32, {EP_B} x {EP_T} tokens, gloo ranks sharing one card "
        f"(not a deployment figure; {card}): " + json.dumps(ep_rows))

    # -- 19b. Trainer(shardings=) ------------------------------------------
    ranks = [r["train"] for r in two]
    r0 = ranks[0]
    losses = r0["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[MESH_FAIL_AT:],
                                                want[MESH_FAIL_AT:])]
    steady = [ms for ms in r0["host_ms"][MESH_FAIL_AT + 1:]]
    log(f"phase 19b Trainer(shardings=), {LM_ARCH} at full width, "
        f"{cfg.n_layers} layers, 2 gloo ranks on one card (not a deployment "
        f"figure; {card}): " + json.dumps(dict(
            placements=kind, why=why, losses=losses, one_process=want,
            steps_0_3_bit_equal=losses[:MESH_FAIL_AT] == want[:MESH_FAIL_AT],
            steps_4_7_max_rel=max(rel), tol=MESH_LOSS_TOL,
            wq_placements=r0["wq_placements"],
            per_rank=[dict(rank=r["rank"], sharded_step_ms=statistics.median(
                r["host_ms"][MESH_FAIL_AT + 1:]), host_ms=r["host_ms"],
                collective_bytes_a_step=r["coll_bytes"],
                collectives_a_step=r["coll_count"], peak_gib=r["peak_gib"],
                writes=r["writes"], s=r["s"]) for r in ranks],
            sharded_step_ms_rank0=statistics.median(steady),
            world_s=world2_s)))
    if not (r0["restarts"] == 1 and r0["steps"] == MESH_STEPS - MESH_FAIL_AT
            and len(losses) == MESH_STEPS):
        raise AssertionError(f"phase 19b: {r0['restarts']} restarts, "
                             f"{r0['steps']} resumed steps, {len(losses)} "
                             f"losses")
    if losses[:MESH_FAIL_AT] != want[:MESH_FAIL_AT]:
        raise AssertionError(f"phase 19b: steps 0-3 {losses[:MESH_FAIL_AT]}"
                             f" differ from one process's "
                             f"{want[:MESH_FAIL_AT]}")
    if max(rel) > MESH_LOSS_TOL:
        raise AssertionError(f"phase 19b: steps 4-7 off one process's by "
                             f"{rel}")
    for r in ranks:
        if r["losses"] != losses or not all(r["kept"]):
            raise AssertionError(f"phase 19b rank {r['rank']}: losses "
                                 f"{r['losses']}, placements kept "
                                 f"{r['kept']}")
        if r["digests"] != digests:
            raise AssertionError(f"phase 19b rank {r['rank']}: the final "
                                 f"checkpoint differs from the state the "
                                 f"rank gathered")
    if ranks[1]["writes"] or r0["writes"] != [
            f"step_{s:08d}" for s in (MESH_CKPT_EVERY, MESH_STEPS,
                                      MESH_STEPS)]:
        raise AssertionError("phase 19b: writes " + json.dumps(
            [r["writes"] for r in ranks]) + ", want rank 0's alone")
    if kind == "fsdp" and r0["wq_placements"] != ["S(0)", "R"]:
        raise AssertionError(f"phase 19b: wq placements "
                             f"{r0['wq_placements']}")

    log(f"phase 19: {time.perf_counter() - t_start:.1f} s ({card})")


def load_twin(name: str):
    """The example twin ``examples_torch/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin_figures(name: str, out: dict) -> dict:
    """The key figures of a twin's returned summary."""
    def lat(snap):
        return dict(qps=snap["qps"], p50_ms=snap["latency"]["p50_ms"],
                    p99_ms=snap["latency"]["p99_ms"])
    if name == "quickstart":
        return dict(loss=out["loss"], accuracy=out["accuracy"])
    if name == "distributed_gnn_inference":
        return dict(max_err=out["max_err"],
                    packed_payload=out["packed_payload"])
    if name == "tune_variants":
        return dict(candidates=out["n_candidates"],
                    best=out["best"].candidate.name(),
                    best_ms=out["best"].latency_s * 1e3)
    if name == "serve_gnn":
        return dict(plan=out["plan"], subgraph=lat(out["subgraph"]),
                    pipelined_qps=out["pipelined"]["qps"],
                    full_cache=lat(out["full_cache"]))
    if name == "serve_sharded":
        return dict(routed=lat(out["routed"]),
                    pipelined_qps=out["pipelined"]["qps"],
                    halo_bytes_by_tag=out["halo_bytes_by_tag"])
    if name == "serve_replicated":
        return {k: out[k] for k in ("steady_qps", "failovers",
                                    "readmissions", "failover_queries",
                                    "reshard_prepare_s")}
    if name == "serve_llm":
        ttft = sorted(out["ttft_ms"])
        return dict(tokens_per_s=out["tokens_per_s"],
                    ttft_ms_p50=ttft[len(ttft) // 2],
                    param_bytes=out["quant_bytes"] or out["fp_bytes"])
    if name == "train_lm":
        return dict(final_loss=out["final_loss"], restarts=out["restarts"],
                    steps_after_restart=out["steps"],
                    train_wall_s=out["wall_s"])
    raise ValueError(name)


def run_examples(torch, stores) -> dict:
    """Phase 20: every example twin's ``main`` on the card (``TWIN_RUNS``),
    and ``ops.launch_stats`` of the GCN "bin" bucket forward of serve ways
    (a) and (c). Returns the twins' kernel launches by kernel name."""
    import contextlib
    import io

    import numpy as np
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # launch_stats: one bucket forward of phase 6's sessions; on the card
    # each kernel entry must be one CUDA launch
    seeds = np.random.default_rng(SEED + 20).integers(
        0, stores["a"].graphs["flickr"].data.n_nodes, size=SERVE_BATCH)
    stats = {}
    for way, fused in (("a", False), ("c", True)):
        sess = stores[way].session("flickr", "gcn")
        prepared = sess.prepare_batch(seeds)
        g = prepared.groups[0]
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        st = ops.launch_stats(g.core._serve_one, g.staged, prepared.bn)
        torch.cuda.synchronize()
        launched = {k: v for k, v in ops.launch_counts().items()
                    if k in REPLACES and "/" not in k and v}
        if st["pallas_calls"] != sum(launched.values()):
            raise AssertionError(f"phase 20 launch_stats way ({way}): "
                                 f"{st['pallas_calls']} kernel entries, "
                                 f"{launched} CUDA launches")
        stats[f"({way}) {'fused' if fused else 'unfused'}"] = dict(
            eqns=st["eqns"], pallas_calls=st["pallas_calls"],
            eqns_per_layer=st["eqns"] / STATS_LAYERS,
            pallas_calls_per_layer=st["pallas_calls"] / STATS_LAYERS,
            launches=launched)
    if not stats["(c) fused"]["eqns"] < stats["(a) unfused"]["eqns"]:
        raise AssertionError(f"phase 20 launch_stats: {stats}")
    log("phase 20 launch_stats, GCN \"bin\" bucket forward, full Flickr, "
        f"{SERVE_BATCH} seeds: " + json.dumps(stats))

    ops.reset_launch_counts()
    rows = []
    for name, argv in TWIN_RUNS:
        mod = load_twin(name)
        with tempfile.TemporaryDirectory(prefix="twin-") as tmp:
            if name == "train_lm":
                argv = argv + ["--ckpt-dir", str(Path(tmp) / "ckpt")]
            elif name in ("serve_gnn", "serve_sharded"):
                argv = argv + ["--trace", str(Path(tmp) / "trace.json")]
            buf = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(buf):
                    out = mod.main(argv)
            except BaseException:
                print(buf.getvalue(), flush=True)
                raise
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        rows.append(dict(twin=name, argv=argv, wall_s=wall,
                         **twin_figures(name, out)))
        log(f"phase 20 {name} {' '.join(argv)}: {wall:.1f} s; "
            + json.dumps(rows[-1]))
    launches = {k: v for k, v in ops.launch_counts().items()
                if k in REPLACES}
    missing = [k for k in FORWARD_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"phase 20: kernels never launched: {missing}")
    log("phase 20 launches: " + json.dumps(launches))
    log(f"phase 20: {time.perf_counter() - t_start:.1f} s for "
        f"{len(TWIN_RUNS)} twin runs ({card})")
    return launches


def walls_line(total_s: float, card: str) -> str:
    """The ``walls:`` record: each phase's seconds, its reference work,
    timing loops and worlds' start-up, and the rest (the card's path and
    its set-up); the total and the card. A record, not a gate."""
    phases = {}
    for name, row in WALLS.items():
        phases[name] = dict(row, rest_s=row.get("s", 0.0) - sum(
            v for k, v in row.items() if k != "s"))
    return "walls: " + json.dumps(dict(phases=phases, total_s=total_s,
                                       card=card))


def main() -> int:
    t_start = time.perf_counter()
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
    card = smi.stdout.strip().splitlines()[0]
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    print(walls_line(time.perf_counter() - t_start, card), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
