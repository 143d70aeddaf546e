"""Training launcher (reference: ``repro/launch/train.py``).

    python -m repro_torch.launch.train --arch smollm-135m --steps 100 \\
        [--device cuda|cpu] [--quant bitgnn] [--compress-grads]

Host mode: trains the reduced config of ``--arch`` for real, on the card
unless ``--device cpu``, with the reference's recipe (AdamW on a cosine
schedule, clip norm 1.0, a checkpoint every 25 steps) and its summary line.
``--mesh single|multi`` runs the full config's ``train_4k`` cell through
the dry run instead (``launch/dryrun.py``: the 256- or 512-card mesh over a
fake process group, tensors on the meta device) and prints its JSON.
``--quant bitgnn`` trains bit-packed projections, which neither package
can differentiate: the step raises ``TypeError`` as the reference's does.
The reference's ``--xla-flags`` is left out: it hands flags to XLA's
compiler (TPU collective overlap), and no XLA compiler runs under torch.
"""
from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--quant", default="none", choices=["none", "bitgnn"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh in ("single", "multi"):
        import json
        from . import dryrun
        r = dryrun.run_cell(args.arch, "train_4k", args.mesh, quant=args.quant)
        print(json.dumps(r, indent=2))
        return r

    import torch
    from ..configs import get_config, reduced_config
    from ..data.pipeline import PrefetchLoader, SyntheticLM
    from ..models import transformer
    from ..optim.optimizer import AdamW, cosine_schedule
    from ..quant import grad_compress as gc
    from ..train.train_step import make_train_step
    from ..train.trainer import Trainer, TrainerConfig

    cfg = reduced_config(get_config(args.arch)).resolve_for_mesh(tp=1)
    opt = AdamW(lr=cosine_schedule(args.lr, 10, args.steps), clip_norm=1.0)
    step = make_train_step(cfg, opt, unroll=False,
                           compress_grads=args.compress_grads)
    loader = PrefetchLoader(SyntheticLM(cfg.vocab, args.seq), args.batch)

    def init_state():
        gen = torch.Generator(device=args.device).manual_seed(0)
        params = transformer.init_params(cfg, gen, args.device)
        if args.quant == "bitgnn":
            from ..quant.binary_linear import quantize_params
            params = quantize_params(params)
        extra = gc.init_error_state(params) if args.compress_grads else ()
        return params, opt.init(params), extra

    trainer = Trainer(cfg, step, init_state, loader, args.ckpt_dir,
                      TrainerConfig(total_steps=args.steps, ckpt_every=25,
                                    log_every=10,
                                    compress_grads=args.compress_grads),
                      device=args.device)
    try:
        out = trainer.run()
    finally:
        loader.close()
    print(f"arch={args.arch} steps={out['steps']} "
          f"final_loss={out['final_loss']:.4f} wall={out['wall_s']:.1f}s")


if __name__ == "__main__":
    main()
