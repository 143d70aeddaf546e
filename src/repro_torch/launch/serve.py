"""Serving launcher (reference: ``repro/launch/serve.py``).

    python -m repro_torch.launch.serve --arch stablelm-1.6b --requests 8 \\
        [--device cuda|cpu] [--quant bitgnn]

Host mode: the reduced config of ``--arch`` with seeded random weights,
served by the ``serve.engine.ServeEngine`` shim (``max_batch=4``,
``max_len=256``) on the card unless ``--device cpu``; prints the
reference's summary line. ``--mesh single|multi`` runs the full config's
``decode_32k`` cell through the dry run instead (``launch/dryrun.py``) and
prints its JSON.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--quant", default="none", choices=["none", "bitgnn"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh in ("single", "multi"):
        import json
        from . import dryrun
        r = dryrun.run_cell(args.arch, "decode_32k", args.mesh,
                            quant=args.quant)
        print(json.dumps(r, indent=2))
        return r

    import numpy as np
    import torch
    from ..configs import get_config, reduced_config
    from ..models import transformer
    from ..serve.engine import Request, ServeEngine

    cfg = reduced_config(get_config(args.arch)).resolve_for_mesh(tp=1)
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = transformer.init_params(cfg, gen, args.device)
    if args.quant == "bitgnn":
        from ..quant.binary_linear import quantize_params
        params = quantize_params(params)
    eng = ServeEngine(cfg, params, max_batch=4, max_len=256,
                      device=args.device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        eng.submit(Request(rid=rid,
                           prompt=rng.integers(0, cfg.vocab, 8),
                           max_new_tokens=args.max_new))
    done = eng.run_until_done()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s on {args.device})")


if __name__ == "__main__":
    main()
