"""The example twins (``examples_torch/``) and ``ops.launch_stats`` against
the JAX package, on the CPU at small sizes.

Each twin's ``main([... "--device", "cpu"])`` runs its walkthrough with
every assert of the reference example. Lines that do not depend on the
hardware are held equal to the reference example's own stdout, run here
in-process with ``runpy`` at the same arguments; where the reference
draws parameters from ``PRNGKey(0)`` (or trains them), the test records
them from that run and carries them to the twin with
``params_from_numpy``. ``launch_stats``: the kernel entries of one bucket
forward against the reference's ``pallas_call`` count under
``force_kernels``. The reference builds its FBB / BBF products and BIN
with jnp ops and routes only the BSpMM stages to Pallas when serving;
the port enters its BIN and BMM kernels as well, so its unfused count is
the reference's plus those entries (pinned below).
"""
import ast
import importlib.util
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.extend.core  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import tuner as jtuner  # noqa: E402
from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve import GraphStore as JStore  # noqa: E402
tg = lazy("repro_torch.models.gnn")
tops = lazy("repro_torch.kernels.ops")
tkernels = lazy("repro_torch.kernels")
tserve = lazy("repro_torch.serve")
td = lazy("repro_torch.graphs.datasets")

jax.config.update("jax_platform_name", "cpu")

ROOT = Path(__file__).resolve().parents[1]
TWINS = ("quickstart", "distributed_gnn_inference", "tune_variants",
         "serve_gnn", "serve_sharded", "serve_replicated", "serve_llm",
         "train_lm")
CPU = ["--device", "cpu"]


def _twin(name: str):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(name: str, capsys, monkeypatch, argv=()) -> str:
    """Run ``examples/<name>.py`` in-process; returns its stdout."""
    monkeypatch.setattr(sys, "argv", [name, *argv])
    capsys.readouterr()
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                   run_name="__main__")
    return capsys.readouterr().out


def _record(monkeypatch, module, attr) -> list:
    """Wrap ``module.attr`` so each call's result is appended to the list
    returned."""
    calls, fn = [], getattr(module, attr)

    def wrapped(*a, **k):
        calls.append(fn(*a, **k))
        return calls[-1]
    monkeypatch.setattr(module, attr, wrapped)
    return calls


def _carry(family, params):
    return tg.params_from_numpy(family, [np.asarray(w) for w in params],
                                "cpu")


def test_quickstart_matches_reference(capsys, monkeypatch):
    """The FRDC / CSR / weight KB lines equal the reference's; on the
    Bi-GCN the reference trained (carried, not trained again: the 150
    epochs are chaotic), the binary test accuracy is equal."""
    trained = _record(monkeypatch, jg, "train_node_classifier")
    want = _reference("quickstart", capsys, monkeypatch).splitlines()
    q = _twin("quickstart")
    q.run("cpu", params=_carry("gcn", trained[0][0]), epochs=0)
    got = capsys.readouterr().out.splitlines()
    assert got == want[1:], (got, want)
    q.main(CPU)          # the twin's own walkthrough, with its training
    own = capsys.readouterr().out.splitlines()
    assert own[0].startswith("trained Bi-GCN, loss=")
    assert own[2:] == want[2:]


def test_distributed_gnn_inference_matches_reference(capsys, monkeypatch):
    want = _reference("distributed_gnn_inference", capsys, monkeypatch)
    out = _twin("distributed_gnn_inference").main(CPU)
    assert capsys.readouterr().out == want
    assert out["max_err"] == 0.0
    assert out["packed_payload"] * 32 == out["fp_payload"]   # 4 B a word


def test_tune_variants_matches_reference(capsys, monkeypatch):
    """Candidate count and names equal; on the reference's init the
    output deltas of the same candidates within 1e-5 (the order of the
    rows is by latency, which the hardware decides)."""
    inits = _record(monkeypatch, jg, "init_gcn")
    tuned = _record(monkeypatch, jtuner, "tune")
    want = _reference("tune_variants", capsys, monkeypatch).splitlines()
    out = _twin("tune_variants").run("cpu", params=_carry("gcn", inits[0]))
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "10 type-correct candidates"
    assert out["n_candidates"] == 10
    ref = {r.candidate.name(): r.output_delta for r in tuned[0]}
    port = {r.candidate.name(): r.output_delta for r in out["results"]}
    assert set(port) == set(ref) and len(port) == 8
    names = sorted(line.split()[0] for line in got[2:10])
    assert names == sorted(line.split()[0] for line in want[2:10])
    for name, delta in ref.items():
        assert abs(port[name] - delta) <= 1e-5, (name, port[name], delta)


def test_serve_gnn_twin():
    out = _twin("serve_gnn").main(CPU + ["--scale", "0.1", "--queries", "64",
                                         "--epochs", "2"])
    assert out["subgraph"]["queries"] == 64
    assert out["cost"]["tenants"]["gold"]["queries"] == 64


def test_serve_sharded_twin_matches_reference_planner():
    """The twin runs its walkthrough; its planner stats and halo bytes by
    tag equal the reference's ``ShardPlanner`` / ``ShardedGraphSession`` at
    the same arguments."""
    args = dict(shards=4, scale=0.05, batch=16)
    out = _twin("serve_sharded").main(
        CPU + ["--shards", "4", "--scale", "0.05", "--queries", "32"])
    d = make_dataset("cora", seed=0, scale=args["scale"])
    store = JStore(max_batch=args["batch"])
    store.register_graph("cora", d)
    store.register_model("gcn", "gcn", jg.init_gcn(
        jax.random.PRNGKey(0), d.x.shape[1], 32, d.n_classes))
    sess = store.sharded_session("cora", "gcn", args["shards"])
    assert out["plan_stats"] == sess.shard_plan.stats()
    assert out["halo_bytes_by_tag"] == dict(sess.halo_stats.bytes_by_tag)


def test_serve_replicated_twin():
    out = _twin("serve_replicated").main(CPU + ["--scale", "0.05"])
    assert out["failovers"] == 1 and out["readmissions"] == 1
    assert out["retry_shed"] >= 4


@pytest.fixture(scope="module")
def llm_bytes():
    """The reference's fp and packed parameter bytes of serve_llm's model."""
    from repro.configs import get_config, reduced_config
    from repro.models import transformer as jt
    from repro.quant.binary_linear import (quantize_params,
                                           quantized_param_bytes)
    cfg = reduced_config(get_config("stablelm-1.6b")).resolve_for_mesh(tp=1)
    params = jt.init_params(jax.random.PRNGKey(0), cfg)
    return (quantized_param_bytes(params),
            quantized_param_bytes(quantize_params(params)))


@pytest.mark.parametrize("quant", [False, True])
def test_serve_llm_twin(quant, llm_bytes, capsys):
    """Streams equal to the stepwise loop at the session's shapes (the
    twin asserts it); across packages only the parameter-byte line."""
    out = _twin("serve_llm").main(
        CPU + ["--requests", "3", "--max-new", "4"]
        + (["--quant"] if quant else []))
    got = capsys.readouterr().out.splitlines()
    assert out["steady_compiles"] == 0 and out["tokens"] == 12
    fp_bytes, q_bytes = llm_bytes
    assert out["fp_bytes"] == fp_bytes
    if quant:
        assert got[0] == (f"bitgnn quantized params: {q_bytes/1e6:.2f} MB "
                          f"(fp: {fp_bytes/1e6:.2f} MB)")


def test_train_lm_twin_restarts(tmp_path, capsys):
    """One injected failure, one restart from the last checkpoint, in the
    directory given; the default directory is not the JAX example's."""
    ckpt = tmp_path / "ckpt"
    out = _twin("train_lm").main(CPU + [
        "--steps", "30", "--layers", "1", "--d-model", "64", "--seq", "16",
        "--batch", "2", "--fail-at", "25", "--ckpt-dir", str(ckpt)])
    assert out["restarts"] == 1 and out["steps"] == 10
    assert np.isfinite(out["final_loss"])
    assert sorted(p.name for p in ckpt.iterdir()) == ["step_00000020",
                                                      "step_00000030"]
    assert "restarts=1" in capsys.readouterr().out
    src = (ROOT / "examples_torch" / "train_lm.py").read_text()
    assert "/tmp/repro_train_lm" not in src


@pytest.fixture(scope="module")
def stats_graph():
    return make_dataset("cora", seed=0, scale=0.05)


@pytest.mark.parametrize("family", ["gcn", "sage", "saint"])
def test_launch_stats_matches_reference(family, stats_graph, monkeypatch):
    """``pallas_calls`` of one bucket forward: fused equal to the
    reference's (one kernel a layer); unfused the reference's BSpMM
    launches plus the port's BIN and BMM entries. ``eqns`` is smaller
    fused than unfused in both packages."""
    # the reference's walk names jax.core.ClosedJaxpr / Jaxpr, which this
    # jax moved to jax.extend.core
    monkeypatch.setattr(jax.core, "ClosedJaxpr",
                        jax.extend.core.ClosedJaxpr, raising=False)
    monkeypatch.setattr(jax.core, "Jaxpr", jax.extend.core.Jaxpr,
                        raising=False)
    d = stats_graph
    seeds = np.random.default_rng(7).integers(0, d.n_nodes, size=8)
    pj = getattr(jg, f"init_{family}")(jax.random.PRNGKey(0), d.x.shape[1],
                                       16, d.n_classes)
    td_graph = td.make_dataset("cora", seed=0, scale=0.05)
    counters = (tkernels.pack_kernel.ENTRIES, tkernels.bmm_kernel.ENTRIES,
                tkernels.bspmm_kernel.ENTRIES, tkernels.fused_layer.ENTRIES)
    ref, port, kinds = {}, {}, {}
    jops.force_kernels(True)
    try:
        for fused in (False, True):
            store = JStore(max_batch=8, use_pallas=True, fused=fused)
            store.register_graph("g", d)
            store.register_model(family, family, pj)
            sess = store.session("g", family)
            sess.serve_subgraph(seeds)
            p = sess.prepare_batch(np.asarray(seeds, np.int64))
            g = p.groups[0]
            ref[fused] = jops.launch_stats(
                g.core._serve_one, jnp.asarray(g.staged.x_pad), p.bn,
                g.staged.adjs, jnp.asarray(g.staged.pos_pad))
    finally:
        jops.force_kernels(False)
    for fused in (False, True):
        store = tserve.GraphStore(max_batch=8, use_pallas=True, fused=fused,
                                  device="cpu")
        store.register_graph("g", td_graph)
        store.register_model(family, family, _carry(family, pj))
        sess = store.session("g", family)
        sess.serve_subgraph(seeds)
        p = sess.prepare_batch(np.asarray(seeds, np.int64))
        g = p.groups[0]
        before = [dict(c) for c in counters]
        port[fused] = tops.launch_stats(g.core._serve_one, g.staged, p.bn)
        kinds[fused] = {k: c[k] - b[k] for c, b in zip(counters, before)
                        for k in c if c[k] != b[k]}
    n_layers = {"gcn": 2, "sage": 2, "saint": 3}[family]
    assert port[True]["pallas_calls"] == ref[True]["pallas_calls"] \
        == n_layers
    assert kinds[True] == {"fused_layer": n_layers}
    bspmm = sum(v for k, v in kinds[False].items() if k.startswith("bspmm"))
    assert bspmm == ref[False]["pallas_calls"] == 2
    extra = {"gcn": {"binarize_pack": 2, "bmm_xnor": 1},
             "sage": {"binarize_pack": 2, "bmm_xnor": 4},
             "saint": {"binarize_pack": 3, "bmm_xnor": 5}}[family]
    assert {k: v for k, v in kinds[False].items()
            if not k.startswith("bspmm")} == extra
    assert port[False]["pallas_calls"] == bspmm + sum(extra.values())
    for stats in (ref, port):
        assert stats[True]["eqns"] < stats[False]["eqns"]


def test_twins_run_on_the_card_by_default():
    """Every twin takes ``--device`` with default ``cuda`` and, with no
    card, raises instead of falling back to the CPU."""
    for name in TWINS:
        tree = ast.parse((ROOT / "examples_torch" / f"{name}.py").read_text())
        defaults = [kw.value.value for node in ast.walk(tree)
                    if isinstance(node, ast.Call) and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value == "--device"
                    for kw in node.keywords if kw.arg == "default"]
        assert defaults == ["cuda"], (name, defaults)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for name in TWINS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _twin(name).main([])
