"""The port's token tier (``repro_torch.serve.{token_session, token_engine,
engine}`` and ``TokenAdapter``) against the reference's on the same
submissions, the port on the CPU.

Held, on ``reduced_config`` of stablelm-1.6b ("transformer") and rwkv6-3b
("ssm"), with the reference's sizes (``tests/test_token_serve.py``):

* served streams bit-equal to the port's own direct ``decode_step`` loop
  at batch 1 and another cache length (the reference's contract; it holds
  on the CPU), and equal to the reference's streams on fp32 replicas of the
  configs (in bf16 an argmax over near-equal logits may part the two
  packages without a fault);
* the same ``batch_log``, ``compile_count`` before and after warmup, and no
  steady-state recompile; a new decode-cache length is a new program
  exactly where the reference's jit traces anew;
* eos truncation, param pinning and hot swap, the deprecated shim, the
  admission / cost / trace plumbing for token tenants, and an injected
  launch fault requeued and served;
* the serving core's upload hook and program key leave the GNN path's
  launches, programs and answers as they were.
"""
import dataclasses

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.configs import get_config, reduced_config  # noqa: E402
from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
torch = lazy("torch")
tconf = lazy("repro_torch.configs")
td = lazy("repro_torch.graphs.datasets")
tg = lazy("repro_torch.models.gnn")
tt = lazy("repro_torch.models.transformer")
tserve = lazy("repro_torch.serve")

jax.config.update("jax_platform_name", "cpu")

ARCHS = {"transformer": "stablelm-1.6b", "ssm": "rwkv6-3b"}
PROMPT_LENS = (2, 5, 10, 1, 7, 3)
NEWS = (3, 8, 2, 6, 1, 5)


def _cfgs(name, dtype="bfloat16"):
    j = reduced_config(get_config(name)).resolve_for_mesh(tp=1)
    t = tconf.reduced_config(tconf.get_config(name)).resolve_for_mesh(tp=1)
    return (dataclasses.replace(j, dtype=dtype),
            dataclasses.replace(t, dtype=dtype))


def _models(kind, dtype="bfloat16", key=0):
    """(reference cfg, params), (port cfg, the same params carried)."""
    cfg, tcfg = _cfgs(ARCHS[kind], dtype)
    pj = jt.init_params(jax.random.PRNGKey(key), cfg)
    return (cfg, pj), (tcfg, tt.params_from_numpy(
        jax.tree.map(np.asarray, pj), "cpu"))


def direct(cfg, params, prompt, max_new):
    """The port's ground truth: a loop of ``decode_step`` at batch 1 with
    argmax feedback, the cache at the reference test's length."""
    total = prompt.size + max_new
    cache = tt.init_cache(cfg, 1, max(64, int(2 ** np.ceil(np.log2(total)))),
                          device="cpu")
    out, prev = [], None
    for t in range(prompt.size + max_new - 1):
        tok = prompt[t] if t < prompt.size else prev
        lg, cache = tt.decode_step(params, cfg, cache,
                                   torch.tensor([[int(tok)]]), t)
        prev = int(torch.argmax(lg[0, 0, :cfg.vocab]))
        if t >= prompt.size - 1:
            out.append(prev)
    return np.asarray(out[:max_new], np.int32)


def _store(serve, cfg, params, **kw):
    store = serve.TokenStore(max_batch=3, max_len=128, chunk=4,
                             warm_len=10, warm_new=8, **kw)
    store.register_model("lm", cfg, params)
    return store


def _serve(serve, cfg, params, prompts, news, store_kw=(), **kw):
    eng = serve.TokenServeEngine(_store(serve, cfg, params, **dict(store_kw)),
                                 **kw)
    warm = eng.warmup("lm")
    c0 = eng.compile_count
    qs = [eng.submit("lm", p, max_new=mn) for p, mn in zip(prompts, news)]
    eng.run_until_drained()
    eng.close()
    assert all(q.done for q in qs)
    return eng, qs, dict(
        warm=warm, after=eng.compile_count - c0,
        steady=eng.snapshot()["watchdogs"]["recompile"]["steady_recompiles"],
        log=[[q.qid for q in b] for b in eng.batch_log])


def _prompts(vocab, lens=PROMPT_LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, ln).astype(np.int32) for ln in lens]


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_served_streams_match_reference(kind):
    (cfg, pj), (tcfg, pt) = _models(kind)
    prompts = _prompts(cfg.vocab)
    _, jqs, jrun = _serve(jserve, cfg, pj, prompts, NEWS, pipeline_depth=1)
    teng, tqs, trun = _serve(tserve, tcfg, pt, prompts, NEWS,
                             store_kw=dict(device="cpu"), pipeline_depth=1)
    assert trun == jrun and trun["warm"] >= 1 and trun["after"] == 0
    assert trun["steady"] == 0
    assert teng.family == kind
    for q, p, mn in zip(tqs, prompts, NEWS):
        assert np.array_equal(q.tokens, direct(tcfg, pt, p, mn))
        assert q.ttft_s > 0.0 and q.t_first_token <= q.t_done
    # fp32 replicas: the two packages' streams are equal
    (c32, p32), (t32, pt32) = _models(kind, "float32")
    _, jqs, _ = _serve(jserve, c32, p32, prompts, NEWS)
    _, tqs, _ = _serve(tserve, t32, pt32, prompts, NEWS,
                       store_kw=dict(device="cpu"))
    for a, b in zip(tqs, jqs):
        assert np.array_equal(a.tokens, b.tokens)


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_new_cache_length_is_a_new_program_as_in_reference(kind):
    """A batch past the warm cache bucket adds a program where the
    reference's jit traces anew (its decode-cache length is in the KV
    shapes; an RWKV cache has no length axis); ``on_trace`` reports the
    reference's (batch, chunk) key."""
    (cfg, pj), (tcfg, pt) = _models(kind)
    seen = {}
    counts = {}
    for name, serve, c, p, kw in (("jax", jserve, cfg, pj, {}),
                                  ("torch", tserve, tcfg, pt,
                                   dict(device="cpu"))):
        sess = serve.TokenSession("s", c, p, max_batch=2, max_len=256,
                                  chunk=4, **kw)
        shapes = seen[name] = []
        sess.set_trace_hook(lambda fam, shape: shapes.append((fam, shape)))
        run = []
        for ln, mn in ((3, 4), (5, 6), (40, 30), (60, 50), (2, 2)):
            sess.run(_prompts(cfg.vocab, (ln,), seed=ln), [mn])
            run.append(sess.compile_count)
        counts[name] = run
    assert counts["torch"] == counts["jax"]
    assert seen["torch"] == seen["jax"]


def test_admission_cost_tracing_for_token_tenants():
    """Token tenants flow through the same admission / cost / span / SLO
    plumbing as in the reference, namespaced by the model family."""
    (cfg, pj), (tcfg, pt) = _models("transformer")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 4).astype(np.int32)
               for _ in range(6)]
    snaps, units = [], []
    for serve, c, p, kw in ((jserve, cfg, pj, {}),
                            (tserve, tcfg, pt, dict(device="cpu"))):
        eng = serve.TokenServeEngine(
            _store(serve, c, p, **kw), cost=serve.CostEstimator(),
            slo=serve.SLOTracker({"acme": serve.SLOPolicy(),
                                  "blue": serve.SLOPolicy()}))
        eng.warmup("lm")
        qs = [eng.submit("lm", pr, max_new=3,
                         tenant="acme" if i % 2 else "blue")
              for i, pr in enumerate(prompts)]
        eng.run_until_drained()
        eng.close()
        snaps.append(eng.snapshot())
        units.append([q.cost.units for q in qs])
        text = serve.prometheus_text(snaps[-1])
        assert 'family="transformer"' in text
    jsnap, tsnap = snaps
    assert units[0] == units[1]
    assert tsnap["family"] == jsnap["family"] == "transformer"
    for tenant in ("acme", "blue"):
        assert tsnap["tenants"][tenant]["accepted"] == \
            jsnap["tenants"][tenant]["accepted"] == 3
        assert tsnap["tenants"][tenant]["cost_units"] > 0.0
    assert tsnap["cost"]["queries_estimated"] == \
        jsnap["cost"]["queries_estimated"] >= 6
    assert tsnap["trace"]["batches_seen"] == jsnap["trace"]["batches_seen"]
    assert "slo" in tsnap


def test_eos_truncates_stream_inclusive():
    (cfg, _), (tcfg, pt) = _models("transformer")
    prompt = _prompts(cfg.vocab, (5,), seed=2)[0]
    plain = tserve.TokenSession("a", tcfg, pt, max_batch=2, max_len=64,
                                chunk=4, device="cpu")
    want = plain.run([prompt], [8])[0]
    eos = int(want[2])
    first = int(np.nonzero(want == eos)[0][0])
    stopped = tserve.TokenSession("b", tcfg, pt, max_batch=2, max_len=64,
                                  chunk=4, eos_id=eos, device="cpu")
    got = stopped.run([prompt], [8])[0]
    assert np.array_equal(got, want[:first + 1])


def test_param_update_pins_staged_batches_and_swaps():
    """A batch staged before ``update_params`` finishes under the params
    it was staged with; later queries serve under the new ones; the swap
    counts one invalidation and adds programs as the reference's does."""
    (cfg, pj), (tcfg, pt) = _models("transformer")
    (_, pj2), (_, pt2) = _models("transformer", key=9)
    prompt = _prompts(cfg.vocab, (4,), seed=3)[0]
    runs = {}
    for name, serve, c, p, p2, kw in (
            ("jax", jserve, cfg, pj, pj2, {}),
            ("torch", tserve, tcfg, pt, pt2, dict(device="cpu"))):
        eng = serve.TokenServeEngine(_store(serve, c, p, **kw))
        eng.warmup("lm")
        sess = eng.store.session("lm")
        staged = sess.prepare_batch([prompt], [4])
        q1 = eng.submit("lm", prompt, max_new=4)
        eng.run_until_drained()
        eng.store.update_params("lm", p2)
        pinned = sess.finish_batch(staged, sess.launch_batch(staged))[0]
        q2 = eng.submit("lm", prompt, max_new=4)
        eng.run_until_drained()
        eng.close()
        runs[name] = (q1.tokens, pinned, q2.tokens, eng.compile_count,
                      eng.snapshot()["invalidations"])
    t1, pinned, t2, compiles, inval = runs["torch"]
    assert np.array_equal(t1, direct(tcfg, pt, prompt, 4))
    assert np.array_equal(pinned, t1)
    assert np.array_equal(t2, direct(tcfg, pt2, prompt, 4))
    assert inval == runs["jax"][4] == 1
    assert compiles == runs["jax"][3]


def test_deprecated_engine_shim_serves_via_token_session():
    from repro_torch.serve.engine import Request, ServeEngine

    (cfg, _), (tcfg, pt) = _models("transformer")
    with pytest.warns(DeprecationWarning):
        eng = ServeEngine(tcfg, pt, max_batch=2, max_len=64, device="cpu")
    prompts = _prompts(cfg.vocab, (3, 6, 4), seed=4)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=5))
    done = eng.run_until_done()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    for r in sorted(done, key=lambda r: r.rid):
        assert r.out_tokens == direct(tcfg, pt, prompts[r.rid], 5).tolist()


def test_injected_launch_fault_requeued_and_served():
    """One injected launch fault: the batch is requeued at the front and
    served on the retry, with the reference's batches, counters and
    retry record; the streams equal the fault-free ones."""
    (cfg, pj), (tcfg, pt) = _models("transformer")
    prompts = _prompts(cfg.vocab)
    runs = {}
    for name, serve, c, p, kw in (("jax", jserve, cfg, pj, {}),
                                  ("torch", tserve, tcfg, pt,
                                   dict(device="cpu"))):
        faults = serve.FaultInjector(seed=0)
        eng = serve.TokenServeEngine(_store(serve, c, p, **kw),
                                     faults=faults, max_retries=2,
                                     retry_backoff_s=0.0)
        eng.warmup("lm")
        faults.fail_next("launch", 1)
        qs = [eng.submit("lm", pr, max_new=mn)
              for pr, mn in zip(prompts, NEWS)]
        raised = 0
        for _ in range(5):
            try:
                eng.run_until_drained()
                break
            except RuntimeError:
                raised += 1
        eng.close()
        assert all(q.done for q in qs)
        runs[name] = dict(
            raised=raised, log=[[q.qid for q in b] for b in eng.batch_log],
            batches=eng.metrics.batches, queries=eng.metrics.queries,
            retries=[q.attempts for q in qs], toks=[q.tokens for q in qs])
    got, want = runs["torch"], runs["jax"]
    assert got["raised"] == want["raised"] == 1
    for k in ("log", "batches", "queries", "retries"):
        assert got[k] == want[k], k
    _, clean, _ = _serve(tserve, tcfg, pt, prompts, NEWS,
                         store_kw=dict(device="cpu"))
    for a, b in zip(got["toks"], clean):
        assert np.array_equal(a, b.tokens)


def test_gnn_path_unchanged_by_upload_hook_and_program_key():
    """The GNN adapter uploads every staged array and keys programs by its
    trace shape, as before; a GCN session's programs, dispatches and
    predictions on three batches equal the reference's."""
    data = make_dataset("cora", seed=0, scale=0.1)
    pj = jg.init_gcn(jax.random.PRNGKey(0), data.x.shape[1], 16,
                     data.n_classes)
    jst = jserve.GraphStore(max_batch=8)
    jst.register_graph("g", data)
    jst.register_model("gcn", "gcn", pj)
    tst = tserve.GraphStore(max_batch=8, device="cpu")
    tst.register_graph("g", td.make_dataset("cora", seed=0, scale=0.1))
    tst.register_model("gcn", "gcn", tg.params_from_numpy(
        "gcn", [np.asarray(w) for w in pj], "cpu"))
    jsess, tsess = jst.session("g", "gcn"), tst.session("g", "gcn")
    tsess.bn = tuple((torch.from_numpy(np.array(m)),
                      torch.from_numpy(np.array(s))) for m, s in jsess.bn)
    rng = np.random.default_rng(0)
    for _ in range(3):
        seeds = rng.integers(0, data.n_nodes, 8)
        want = np.asarray(jsess.serve_subgraph(seeds))
        got = tsess.serve_subgraph(seeds)
        assert np.array_equal(got.argmax(-1), want.argmax(-1))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert tsess.core.compile_count == jsess.core.compile_count
    assert tsess.core.n_dispatches == jsess.core.n_dispatches
    prepared = tsess.prepare_batch(rng.integers(0, data.n_nodes, 8))
    staged = prepared.groups[0].staged
    adapter = tsess.core.adapter
    assert adapter.program_key(staged, prepared.bn) == \
        adapter.trace_shape(staged)
    x, operands, seeds = adapter.upload(tsess.core, staged)
    assert isinstance(x, torch.Tensor) and isinstance(seeds, torch.Tensor)
    assert all(isinstance(v, torch.Tensor)
               for a in operands.values() for v in a.values())
    assert set(operands) == set(staged.adjs)
