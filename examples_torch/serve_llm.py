"""Token serving example: the family-adapter serving core driving a reduced
binary LM through TokenServeEngine — admission, cost attribution and span
tracing shared with the GNN engines, zero steady-state recompiles, and the
served streams asserted BITWISE equal to a direct ``decode_step`` loop.
Optionally with BitGNN bit-packed weights (32x smaller projections).

    PYTHONPATH=src python examples_torch/serve_llm.py --requests 6 --quant [--device cpu]

Runs on the CUDA card unless ``--device cpu``; with no card it raises. The
direct loop runs at the shapes the session served each batch at (its batch
and cache length): bf16 products of other shapes may round otherwise, and
an argmax over near-equal logits then parts the streams.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import transformer
from repro_torch.quant.binary_linear import (quantize_params,
                                             quantized_param_bytes)
from repro_torch.serve.token_engine import TokenServeEngine
from repro_torch.serve.token_session import TokenStore


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this example runs on the card "
                           "(pass --device cpu to run it on the CPU)")
    return dev


def direct_reference(cfg, params, prompts, max_new, batch, cache_len,
                     device):
    """Ground truth for one served batch: a python loop of decode_step
    with argmax feedback at the session's ``batch`` and ``cache_len``, each
    slot fed its prompt while it lasts — the program the serving path must
    reproduce bitwise. Returns each request's ``max_new`` tokens."""
    lens = [int(p.size) for p in prompts]
    steps = max(lens) + max_new - 1
    grid = np.zeros((batch, steps), np.int32)
    for i, p in enumerate(prompts):
        grid[i, :p.size] = p
    grid = torch.from_numpy(grid).to(device)
    fed = torch.tensor(lens + [0] * (batch - len(lens)), device=device)
    cache = transformer.init_cache(cfg, batch, cache_len, device=device)
    prev = torch.zeros(batch, dtype=torch.int32, device=device)
    out = []
    for t in range(steps):
        tok = torch.where(t < fed, grid[:, t], prev)
        logits, cache = transformer.decode_step(params, cfg, cache,
                                                tok[:, None], t)
        prev = torch.argmax(logits[:, 0, :cfg.vocab], dim=-1).to(torch.int32)
        out.append(prev)
    out = torch.stack(out, dim=1).cpu().numpy()
    return [out[i, n - 1:n - 1 + max_new] for i, n in enumerate(lens)]


def run(requests: int = 6, max_new: int = 12, quant: bool = False,
        device="cuda", params=None) -> dict:
    """The walkthrough; ``params`` replaces the seeded init. Returns the
    figures it prints."""
    args = argparse.Namespace(requests=requests, max_new=max_new,
                              quant=quant)
    dev = _device(device)
    cfg = reduced_config(get_config("stablelm-1.6b")).resolve_for_mesh(tp=1)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = transformer.init_params(cfg, gen, dev)
    fp_bytes = quantized_param_bytes(params)
    q_bytes = None
    if args.quant:
        q_bytes = quantized_param_bytes(quantize_params(params))
        print(f"bitgnn quantized params: "
              f"{q_bytes/1e6:.2f} MB "
              f"(fp: {fp_bytes/1e6:.2f} MB)")

    store = TokenStore(max_batch=4, max_len=128, chunk=8,
                       warm_len=12, warm_new=args.max_new, device=dev)
    store.register_model("lm", cfg, params, quantize=args.quant)
    eng = TokenServeEngine(store)
    warm = eng.warmup("lm")
    c0 = eng.compile_count

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(3, 10)).astype(np.int32)
               for _ in range(args.requests)]
    queries = eng.submit_many("lm", prompts, max_new=args.max_new)
    eng.run_until_drained()
    eng.close()
    snap = eng.snapshot()

    qparams = quantize_params(params) if args.quant else params
    cache_len = store.session("lm").core._n_water
    refs = {}
    for batch in eng.batch_log:
        want = direct_reference(cfg, qparams, [q.prompt for q in batch],
                                args.max_new, store.max_batch, cache_len,
                                dev)
        refs.update((q.qid, w) for q, w in zip(batch, want))
    for q, prompt in zip(queries, prompts):
        ref = refs[q.qid]
        assert np.array_equal(q.tokens, ref), \
            f"query {q.qid}: served stream diverged from decode_step loop"
        print(f"req {q.qid}: prompt[{prompt.size}] -> {q.tokens.tolist()} "
              f"(ttft {q.ttft_s*1e3:.1f} ms)")
    steady = eng.compile_count - c0
    print(f"served == direct decode_step loop for all {len(queries)} "
          f"requests; warmup compiles {warm}, steady-state compiles {steady}")
    n_tok = sum(len(q.tokens) for q in queries)
    return dict(fp_bytes=fp_bytes, quant_bytes=q_bytes, tokens=n_tok,
                tokens_per_s=n_tok / snap["elapsed_s"],
                ttft_ms=[q.ttft_s * 1e3 for q in queries],
                warmup_compiles=warm, steady_compiles=steady)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--quant", action="store_true")
    ap.add_argument("--device", default="cuda")
    return run(**vars(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
