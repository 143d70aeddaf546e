"""Checkpoint-load robustness of the port's serving artifacts
(``repro_torch.serve``) against the reference's, case for case of
``tests/test_artifact_robustness.py``, the port on the CPU.

Each package saves its own artifacts and the same damage is done to
both, through the chaos seam's ``corrupt_artifact`` where the reference
does. Identical: the outcome (a typed ``ArtifactError``, or None / a
silent rebuild for MISSING artifacts), the file the error names and its
field. A healthy artifact restores without a rebuild and serves the same
answers as a fresh build, bit for bit within the port. Sizes are the
reference's: ``make_dataset("cora", seed=0, scale=0.05)``, hidden 16,
batch 8.
"""
import json
from pathlib import Path

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()

import jax  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.graphs.datasets import make_dataset  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve import session_core as jsc  # noqa: E402
td = lazy("repro_torch.graphs.datasets")
tg = lazy("repro_torch.models.gnn")
tserve = lazy("repro_torch.serve")
tsc = lazy("repro_torch.serve.session_core")

jax.config.update("jax_platform_name", "cpu")

BATCH = 8


@pytest.fixture(scope="module")
def packages():
    """(serve module, session_core, GraphData, params, store kwargs) for
    the reference, then for the port on the CPU."""
    data = make_dataset("cora", seed=0, scale=0.05)
    pj = jg.init_gcn(jax.random.PRNGKey(0), data.x.shape[1], 16,
                     data.n_classes)
    return ((jserve, jsc, data, pj, {}),
            (tserve, tsc, td.make_dataset("cora", seed=0, scale=0.05),
             tg.params_from_numpy("gcn", [np.asarray(w) for w in pj],
                                  "cpu"), dict(device="cpu")))


def _store(pkg, cache_dir):
    serve, _, data, params, kw = pkg
    st = serve.GraphStore(cache_dir=str(cache_dir), max_batch=BATCH, **kw)
    st.register_graph("g", data)
    st.register_model("gcn", "gcn", params)
    return st


def _outcome(fn):
    """What a load did: ("error", file name, field) for an ArtifactError
    of either package, else ("ok", the value)."""
    try:
        return ("ok", fn())
    except (jsc.ArtifactError, tsc.ArtifactError) as e:
        assert e.path in str(e)
        return ("error", Path(e.path).name, e.field)


# ------------------------------------------------------- sidecar loader -----

def test_load_sidecar(packages, tmp_path):
    """A missing sidecar is None; a truncated one, one without a required
    field and one that is not an object raise, naming the file and the
    field."""
    cases = {
        "missing": (None, ()),
        "truncated": (json.dumps(dict(plan={}, fingerprint={})), ("plan",)),
        "missing_field": (json.dumps(dict(plan={})),
                          ("plan", "fingerprint")),
        "non_object": (json.dumps([1, 2, 3]), ()),
    }
    got = {}
    for i, (serve, sc, *_) in enumerate(packages):
        for name, (text, required) in cases.items():
            p = tmp_path / f"{i}_{name}" / "plan.json"
            p.parent.mkdir()
            if text is not None:
                p.write_text(text)
            if name == "truncated":
                serve.FaultInjector().corrupt_artifact(p, keep_bytes=10)
            got[i, name] = _outcome(
                lambda: sc.load_sidecar(p, required=required))
    want = {"missing": ("ok", None),
            "truncated": ("error", "plan.json", "json"),
            "missing_field": ("error", "plan.json", "fingerprint"),
            "non_object": ("error", "plan.json", "json")}
    for name in cases:
        assert got[1, name] == got[0, name] == want[name], name


# ------------------------------------------------- single-host artifacts ----

def _damage_single(serve, d: Path, case: str) -> None:
    if case == "plan_json":
        serve.FaultInjector().corrupt_artifact(d / "plan.json", keep_bytes=20)
    elif case == "weight_npz":
        serve.FaultInjector().corrupt_artifact(
            next(d.glob("step_*/shard_0.npz")))
    elif case == "manifest":
        serve.FaultInjector().corrupt_artifact(
            next(d.glob("step_*/manifest.json")), keep_bytes=5)
    elif case == "missing_npz":
        next(d.glob("step_*/shard_0.npz")).unlink()


@pytest.mark.parametrize("case,want", [
    ("plan_json", ("error", "plan.json", "json")),
    ("weight_npz", ("error", "shard_0.npz", "leaves")),
    ("manifest", ("error", "manifest.json", "json")),
    ("missing_npz", ("error", "shard_0.npz", "shards")),
    ("no_artifacts", ("ok", 0)),
    ("intact", ("ok", 0))])
def test_single_host_artifacts(packages, tmp_path, case, want):
    """Damaged single-host artifacts raise a typed error naming the file
    and field. With no artifacts at all the store rebuilds silently; an
    intact artifact restores with no program built and serves a fresh
    build's answers."""
    got = []
    for i, pkg in enumerate(packages):
        root = tmp_path / str(i)
        if case != "no_artifacts":
            st = _store(pkg, root)
            st.session("g", "gcn")
            assert (root / "g__gcn" / "plan.json").exists()
            _damage_single(pkg[0], root / "g__gcn", case)
        fresh = _store(pkg, root)
        out = _outcome(lambda: fresh.session("g", "gcn"))
        if out[0] == "ok":
            sess = out[1]
            out = ("ok", sess.compile_count if case == "intact" else 0)
            want_logits = _store(pkg, tmp_path / f"other{i}").session(
                "g", "gcn").serve_subgraph(np.arange(4))
            logits = np.asarray(sess.serve_subgraph(np.arange(4)))
            np.testing.assert_array_equal(logits, np.asarray(want_logits))
            got.append((out, logits))
        else:
            got.append((out, None))
    assert got[1][0] == got[0][0] == want
    if want[0] == "ok":
        np.testing.assert_allclose(got[1][1], got[0][1], rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------- sharded artifacts -----

@pytest.mark.parametrize("case,want", [
    ("routing_json", ("error", "routing.json", "json")),
    ("routing_field", ("error", "routing.json", "routing")),
    ("shard_npz", ("error", "shard_0.npz", "leaves"))])
def test_sharded_artifacts(packages, tmp_path, case, want):
    """A truncated ``routing.json``, a structurally broken routing table
    and a truncated shard checkpoint each raise a typed error naming the
    file and field."""
    got = []
    for i, pkg in enumerate(packages):
        serve = pkg[0]
        root = tmp_path / str(i)
        _store(pkg, root).sharded_session("g", "gcn", 2)
        d = root / "g__gcn__P2"
        assert (d / "routing.json").exists()
        if case == "routing_json":
            serve.FaultInjector().corrupt_artifact(d / "routing.json",
                                                   keep_bytes=30)
        elif case == "routing_field":
            sidecar = json.loads((d / "routing.json").read_text())
            sidecar["routing"] = {"wrong": 1}
            (d / "routing.json").write_text(json.dumps(sidecar))
        else:
            serve.FaultInjector().corrupt_artifact(
                next(d.glob("step_*/shard_0.npz")))
        fresh = _store(pkg, root)
        got.append(_outcome(lambda: fresh.sharded_session("g", "gcn", 2)))
    assert got[1] == got[0] == want
