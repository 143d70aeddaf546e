#!/usr/bin/env python3
"""The dry run's memory estimate against the card, allocation by
allocation: where ``chip_smoke.py`` phase 17b's estimate and the measured
peak part.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 tools/dryrun_memory.py [--kind train|decode] [--top 12]

``train``: smollm-135m at full width, one AdamW step of batch 8 x 128 from
fresh parameters (phase 16a's recipe); ``decode``: one ``decode_step`` of
stablelm-1.6b at batch 4, cache 512. The step runs once on the card under
``torch.cuda.memory._record_memory_history`` (the arguments built before
recording starts) and once as the dry run's meta-device trace on a 1 x 1
host mesh (``launch.dryrun._trace_cell``). For each it prints the peak of
the step's own allocations (above its arguments), and the allocations
live at that peak grouped by the innermost frame in ``repro_torch`` that
made them; then the groups whose bytes differ, largest first. The card's
sizes are the caching allocator's blocks (rounded up to 512 bytes).
"""
from __future__ import annotations

import argparse
import collections
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _site(frames) -> str:
    """The innermost frame in the port's package, as file:line func."""
    for f in frames:
        if "repro_torch" in f[0] and "launch/dryrun" not in f[0] \
                and "distributed/" not in f[0]:
            return f"{f[0].split('src/')[-1]}:{f[1]} {f[2]}"
    return "(outside the port)"


def card_peak(torch, build, step) -> tuple:
    """(peak bytes above the arguments, {site: bytes live at the peak})."""
    args = build()
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                             stacks="python")
    out = step(*args)
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    del out, args
    live, total, peak, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            frames = [(f["filename"], f["line"], f["name"])
                      for f in ev.get("frames", [])]
            live[ev["addr"]] = (ev["size"], _site(frames))
            total += ev["size"]
            if total > peak:
                peak, at_peak = total, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            total -= live.pop(ev["addr"])[0]
    return peak, _by_site(at_peak.values())


def meta_peak(torch, cfg, shape, opts, opt) -> tuple:
    """The dry run's trace with the site of each storage it creates."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh

    class Sited(dryrun._StepTrace):
        """The trace, logging each storage's birth (with its site) and
        death, and how many were the step's arguments."""

        def __init__(self):
            super().__init__()
            self.events, self.n_args = [], 0

        def storages(self, tree):
            out = super().storages(tree)
            self.n_args = len(self.events)
            return out

        def _track(self, t):
            if type(t) is torch.Tensor and \
                    id(t.untyped_storage()) not in self._sizes:
                frames = [(f.filename, f.lineno, f.name)
                          for f in reversed(traceback.extract_stack())]
                key = id(t.untyped_storage())
                super()._track(t)
                self.events.append((key, self._sizes[key], _site(frames)))

        def _free(self, key):
            super()._free(key)
            self.events.append((key, None, None))

    trace = {}
    real = dryrun._StepTrace
    dryrun._StepTrace = lambda: trace.setdefault("t", Sited())
    try:
        with make_host_mesh() as mesh:
            dryrun._trace_cell(cfg, shape, mesh, opts,
                               unroll=shape.kind == "decode", opt=opt)
    finally:
        dryrun._StepTrace = real
    events = trace["t"].events
    args = {k for k, _, _ in events[:trace["t"].n_args]}
    live, total, peak, at_peak = {}, 0, 0, {}
    for key, n, site in events:
        if n is not None:
            if key not in args:
                live[key] = (n, site)
                total += n
                if total > peak:
                    peak, at_peak = total, dict(live)
        elif key in live:
            total -= live.pop(key)[0]
    return peak, _by_site(at_peak.values())


def _by_site(items) -> dict:
    out = collections.defaultdict(int)
    for n, site in items:
        out[site] += n
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default="train", choices=["train", "decode"])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import transformer
    from repro_torch.optim.optimizer import AdamW, cosine_schedule
    from repro_torch.train.train_step import make_serve_step, make_train_step

    if not torch.cuda.is_available():
        print("dryrun_memory: no CUDA device", file=sys.stderr)
        return 1
    opts = dict(remat=False, seq_shard=False, q_chunk=0, donate_cache=False)
    opt = AdamW(lr=cosine_schedule(cs.LM_LR, 10, cs.LM_STEPS), clip_norm=1.0)
    if args.kind == "train":
        cfg = cs.token_config(cs.LM_ARCH)
        shape = ShapeConfig("train", cs.LM_SEQ, cs.LM_BATCH, "train")
        sample = SyntheticLM(cfg.vocab, cs.LM_SEQ).sample(
            np.random.default_rng(cs.SEED), cs.LM_BATCH)

        def build():
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
            params = transformer.init_params(cfg, gen, "cuda")
            batch = {k: torch.from_numpy(v).cuda() for k, v in sample.items()}
            return params, opt.init(params), batch
        step = make_train_step(cfg, opt, unroll=False)
    else:
        cfg = cs.token_config(cs.DRY_SERVE_ARCH)
        b, s_len = cs.DRY_DECODE
        shape = ShapeConfig("decode", s_len, b, "decode")

        def build():
            gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
            params = transformer.init_params(cfg, gen, "cuda")
            cache = transformer.init_cache(cfg, b, s_len, device="cuda")
            tokens = torch.zeros((b, 1), dtype=torch.int32, device="cuda")
            return params, cache, tokens, s_len - 1
        step = make_serve_step(cfg)
    card, card_sites = card_peak(torch, build, step)
    meta, meta_sites = meta_peak(torch, cfg, shape, opts, opt)
    print(f"{args.kind}: step peak above the arguments, card {card} bytes, "
          f"dry run {meta} bytes, difference {card - meta}")
    for name, sites in (("card", card_sites), ("dry run", meta_sites)):
        print(f"-- live at the {name}'s peak, by site:")
        for site, n in sorted(sites.items(), key=lambda kv: -kv[1])[
                :args.top]:
            print(f"  {n:>14,d}  {site}")
    diff = {s: card_sites.get(s, 0) - meta_sites.get(s, 0)
            for s in set(card_sites) | set(meta_sites)}
    print("-- card minus dry run, by site:")
    for site, n in sorted(diff.items(), key=lambda kv: -abs(kv[1]))[
            :args.top]:
        if n:
            print(f"  {n:>+14,d}  {site}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
