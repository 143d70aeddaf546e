"""Card-only tests of the token tier (``repro_torch.models.transformer``,
``repro_torch.serve.token_session`` / ``token_engine``) on
``reduced_config`` sizes. They need a CUDA device and skip elsewhere. No
JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_token.py

* ``decode_chunk`` equals a loop of ``decode_step`` bit for bit on the
  card, logits and every cache leaf (zamba2, rwkv6; fp and bit-packed);
* served streams equal a stepwise loop on the card at the session's own
  batch and cache length, with no new program after warmup;
* a depth-1 drain with the launch stage inside ``strict_guard()`` (CUDA
  sync debug mode "error") raises nothing and counts no sync;
* the MoE block and a MoE decode repeat bit for bit (the combine adds in a
  fixed order, not by atomics);
* card logits against the CPU's on the same weights: rtol = atol = 0.15 in
  bf16 (stablelm; the reference's forward-vs-decode rule), 1e-4 on an fp32
  replica (zamba2).
"""
import dataclasses

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

tconf = lazy("repro_torch.configs")
tmoe = lazy("repro_torch.models.moe")
tt = lazy("repro_torch.models.transformer")
tq = lazy("repro_torch.quant.binary_linear")
serve = lazy("repro_torch.serve")

ARCHS = {"transformer": "stablelm-1.6b", "ssm": "rwkv6-3b"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(name, **kw):
    cfg = tconf.reduced_config(tconf.get_config(name)).resolve_for_mesh(tp=1)
    return dataclasses.replace(cfg, **kw)


def _params(cfg, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return tt.init_params(cfg, gen, device)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["zamba2-1.2b", "rwkv6-3b"])
@pytest.mark.parametrize("quant", [False, True])
def test_decode_chunk_bitexact_on_card(cuda, name, quant):
    cfg = _cfg(name)
    p = _params(cfg, cuda)
    if quant:
        p = tq.quantize_params(p)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 9), generator=gen, device=cuda)
    cache_s = tt.init_cache(cfg, 2, 32, device=cuda)
    rows = []
    for i in range(tok.shape[1]):
        lg, cache_s = tt.decode_step(p, cfg, cache_s, tok[:, i:i + 1], i)
        rows.append(lg[:, 0])
    got, cache_c = tt.decode_chunk(p, cfg, tt.init_cache(cfg, 2, 32,
                                                         device=cuda), tok, 0)
    assert torch.equal(got, torch.stack(rows, dim=1))
    ls, lc = _leaves(cache_s), _leaves(cache_c)
    assert len(ls) == len(lc) > 0
    assert all(torch.equal(a, b) for a, b in zip(ls, lc))


def _stepwise(cfg, params, prompts, news, batch, cache_len, device):
    """A loop of ``decode_step`` at the served shapes, argmax read back to
    the host every step."""
    lens = [p.size for p in prompts]
    steps = max(n + m for n, m in zip(lens, news)) - 1
    cache = tt.init_cache(cfg, batch, cache_len, device=device)
    prev = np.zeros(batch, np.int32)
    gens = []
    for t in range(steps):
        tok = prev.copy()
        for i, p in enumerate(prompts):
            if t < lens[i]:
                tok[i] = p[t]
        lg, cache = tt.decode_step(params, cfg, cache,
                                   torch.from_numpy(tok[:, None]).to(device),
                                   t)
        prev = torch.argmax(lg[:, 0, :cfg.vocab], dim=-1).to(
            torch.int32).cpu().numpy()
        gens.append(prev)
    gens = np.stack(gens, axis=1)
    return [gens[i, n - 1:n - 1 + m] for i, (n, m) in enumerate(zip(lens,
                                                                    news))]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_served_streams_equal_same_shape_loop(cuda, kind):
    cfg = _cfg(ARCHS[kind])
    p = _params(cfg, cuda)
    store = serve.TokenStore(max_batch=3, max_len=128, chunk=4, warm_len=10,
                             warm_new=8, device=cuda)
    store.register_model("lm", cfg, p)
    eng = serve.TokenServeEngine(store, pipeline_depth=1)
    eng.warmup("lm")
    c0 = eng.compile_count
    rng = np.random.default_rng(0)
    news = [3, 8, 2, 6, 1, 5]
    qs = [eng.submit("lm", rng.integers(0, cfg.vocab, ln).astype(np.int32),
                     max_new=mn) for ln, mn in zip((2, 5, 10, 1, 7, 3), news)]
    eng.run_until_drained()
    eng.close()
    assert all(q.done and q.t_first_token > 0.0 for q in qs)
    assert eng.compile_count == c0
    cache_len = store.session("lm").core._n_water
    for batch in eng.batch_log:
        want = _stepwise(cfg, p, [q.prompt for q in batch],
                         [q.max_new for q in batch], 3, cache_len, cuda)
        for q, w in zip(batch, want):
            assert np.array_equal(q.tokens, w)


@pytest.mark.gpu
def test_strict_guard_drain_counts_no_sync(cuda):
    cfg = _cfg("zamba2-1.2b")
    store = serve.TokenStore(max_batch=3, max_len=128, chunk=4, device=cuda)
    store.register_model("lm", cfg, _params(cfg, cuda))

    class Guarded(serve.TokenServeEngine):
        def _launch_stage(self, inf):
            with self.transfer_watchdog.strict_guard():
                super()._launch_stage(inf)

    eng = Guarded(store, pipeline_depth=1, max_retries=1,
                  retry_backoff_s=0.0)
    eng.warmup("lm")
    rng = np.random.default_rng(1)
    qs = [eng.submit("lm", rng.integers(0, cfg.vocab, 6).astype(np.int32),
                     max_new=5) for _ in range(6)]
    eng.run_until_drained()
    eng.close()
    assert all(q.done for q in qs)
    assert eng.transfer_watchdog.snapshot()["host_sync_in_launch"] == 0


@pytest.mark.gpu
def test_moe_repeats_bit_for_bit(cuda):
    cfg = _cfg("qwen2-moe-a2.7b", capacity_factor=1.0)
    p = _params(cfg, cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((4, 64, cfg.d_model), generator=gen, device=cuda).to(
        cfg.compute_dtype)
    outs = [tmoe.moe_block(p["blocks"][0]["moe"], x, cfg) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    tok = torch.randint(0, cfg.vocab, (3, 6), generator=gen, device=cuda)
    runs = [tt.decode_chunk(p, cfg, tt.init_cache(cfg, 3, 16, device=cuda),
                            tok, 0)[0] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name,dtype,tol", [
    ("stablelm-1.6b", "bfloat16", 0.15), ("zamba2-1.2b", "float32", 1e-4)])
def test_card_logits_match_cpu(cuda, name, dtype, tol):
    cfg = _cfg(name, dtype=dtype)
    p = _params(cfg, "cpu")
    tok = torch.randint(0, cfg.vocab, (2, 8),
                        generator=torch.Generator().manual_seed(3))

    def on(device):
        pd = _to(p, device)
        full = tt.forward(pd, cfg, tok.to(device))
        dec, _ = tt.decode_chunk(pd, cfg, tt.init_cache(cfg, 2, 16,
                                                        device=device),
                                 tok.to(device), 0)
        return full.float().cpu(), dec.float().cpu()

    (fc, dc), (fh, dh) = on(cuda), on("cpu")
    torch.testing.assert_close(fc, fh, rtol=tol, atol=tol)
    torch.testing.assert_close(dc, dh, rtol=tol, atol=tol)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device)
