"""End-to-end training: train the ~135M smollm architecture for a few hundred
steps with the full production stack — train step, async checkpointing,
fault-tolerant restart loop, straggler-tolerant loader.

    PYTHONPATH=src python examples_torch/train_lm.py --steps 200 --layers 6 [--device cpu]

(--layers reduces depth for CPU wall time; pass 30 for the full config.)
Runs on the CUDA card unless ``--device cpu``; with no card it raises. The
checkpoints go to ``--ckpt-dir`` (default: ``repro_torch_train_lm`` in the
temp directory, not the JAX example's, whose checkpoints this package
would resume).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import PrefetchLoader, SyntheticLM
from repro_torch.models import transformer
from repro_torch.optim.optimizer import AdamW, cosine_schedule
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import (FailureInjector, Trainer,
                                       TrainerConfig, run_with_restarts)


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on the card "
                           "(pass --device cpu to run it on the CPU)")
    return dev


def run(steps: int = 200, layers: int = 6, d_model: int = 256,
        seq: int = 128, batch: int = 8, ckpt_dir: str = None,
        fail_at: int = -1, device="cuda", params=None) -> dict:
    """The training run; ``params`` replaces the seeded init of every fresh
    start. Returns ``run_with_restarts``' summary."""
    args = argparse.Namespace(steps=steps, layers=layers, d_model=d_model,
                              seq=seq, batch=batch, fail_at=fail_at,
                              ckpt_dir=ckpt_dir or os.path.join(
                                  tempfile.gettempdir(),
                                  "repro_torch_train_lm"))
    dev = _device(device)
    cfg = get_config("smollm-135m")
    cfg = dataclasses.replace(
        cfg, n_layers=args.layers, d_model=args.d_model,
        d_ff=args.d_model * 8 // 3 // 64 * 64 or 256,
        n_heads=4, n_kv_heads=2, head_dim=args.d_model // 4,
        vocab=2048).resolve_for_mesh(tp=1)
    print(f"model: {cfg.param_count()/1e6:.1f}M params "
          f"({cfg.n_layers}L d={cfg.d_model})")

    opt = AdamW(lr=cosine_schedule(3e-3, 20, args.steps), weight_decay=0.01,
                clip_norm=1.0)
    step = make_train_step(cfg, opt, unroll=False)

    # ONE injector across restarts — a node dies once, not on every retry
    failer = FailureInjector(args.fail_at) if args.fail_at >= 0 else None
    loaders = []

    def make_trainer():
        loader = PrefetchLoader(SyntheticLM(cfg.vocab, args.seq, seed=0),
                                batch=args.batch, seed=0)
        loaders.append(loader)

        def init_state():
            if params is not None:
                p = params
            else:
                gen = torch.Generator(device=dev).manual_seed(0)
                p = transformer.init_params(cfg, gen, dev)
            return p, opt.init(p), ()

        return Trainer(cfg, step, init_state, loader, args.ckpt_dir,
                       TrainerConfig(total_steps=args.steps, ckpt_every=20,
                                     log_every=20),
                       failer=failer, device=dev)

    try:
        out = run_with_restarts(make_trainer, max_failures=2)
        print(f"done: steps={out['steps']} "
              f"final_loss={out['final_loss']:.4f} "
              f"restarts={out['restarts']} wall={out['wall_s']:.1f}s "
              f"straggler_misses={out['straggler_misses']}")
        for h in make_trainer().history:
            pass
        print("loss curve:", [round(l, 3) for l in out["losses"][::20]])
    finally:
        for loader in loaders:
            loader.close()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: repro_torch_"
                         "train_lm in the temp directory)")
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a node failure at this step (demo)")
    ap.add_argument("--device", default="cuda")
    return run(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
