#!/usr/bin/env python3
"""SHA-256 digests of the MoE block on plain tensors, to hold two trees'
blocks bit for bit on one device.

``models.moe.moe_block`` of qwen2-moe-a2.7b and llama4-scout-17b-a16e at
``moe_groups`` 0, 2 and -1 (the global dispatch without a mesh), at full
width on the card (the reduced configs on the CPU), from seeded parameters
and tokens (``B`` x ``T``): one forward and the backward of
``sum(out * r)``. For each case the digest of the output, of the tokens'
gradient and of each parameter's gradient. ``--tree DIR`` runs the block
of another tree (an earlier commit unpacked with ``git archive``);
``--save F`` writes the digests, ``--compare F`` fails unless every one
equals F's.

    python3 tools/moe_digest.py [--device cpu] [--tree DIR]
        [--save F | --compare F]
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = Path(sys.argv[sys.argv.index("--tree") + 1]).resolve() \
    if "--tree" in sys.argv else HERE
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e")
GROUPS = (0, 2, -1)
B, T = 2, 64


def _digest(t) -> str:
    """The SHA-256 of ``t``'s bytes."""
    import torch
    return hashlib.sha256(t.detach().contiguous().view(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()


def digests(device: str) -> dict:
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models.moe import init_moe, moe_block

    out = {}
    for arch in ARCHS:
        base = get_config(arch) if device.startswith("cuda") \
            else reduced_config(get_config(arch))
        for groups in GROUPS:
            cfg = dataclasses.replace(base, moe_groups=groups) \
                .resolve_for_mesh(tp=1)
            gen = torch.Generator(device=device).manual_seed(groups + 1)
            p = {k: v.requires_grad_(True) for k, v in
                 init_moe(gen, cfg, cfg.compute_dtype, device).items()}
            x = torch.randn((B, T, cfg.d_model), generator=gen,
                            device=device).to(cfg.compute_dtype)
            x.requires_grad_(True)
            r = torch.randn(x.shape, generator=gen, device=device)
            y = moe_block(p, x, cfg)
            (y.float() * r).sum().backward()
            out[f"{arch}/moe_groups={groups}"] = dict(
                out=_digest(y), x_grad=_digest(x.grad),
                **{f"{k}_grad": _digest(v.grad) for k, v in sorted(
                    p.items())})
            del p, x, y
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tree", default=None,
                    help="run the MoE block of this tree")
    ap.add_argument("--save", default=None)
    ap.add_argument("--compare", default=None)
    args = ap.parse_args(argv)
    import torch
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("no card: pass --device cpu")
    got = digests(args.device)
    res = {"tree": str(ROOT), "device": args.device, "cases": len(got)}
    if args.save:
        Path(args.save).write_text(json.dumps(got, indent=1) + "\n")
    if args.compare:
        want = json.loads(Path(args.compare).read_text())
        differ = sorted(f"{case}/{k}" for case in want
                        for k in want[case]
                        if got.get(case, {}).get(k) != want[case][k])
        res.update(equal=sum(len(v) for v in want.values()) - len(differ),
                   of=sum(len(v) for v in want.values()), differ=differ)
    print(json.dumps(res))
    if args.compare and res["differ"]:
        raise SystemExit(1)
    return res


if __name__ == "__main__":
    main()
