"""The port's spans (``repro_torch.kernels.counting``): the forward path's
spans only under a torch profiler, in the tree the forwards run, with the
logits unchanged; the FRDC build's spans always; the ring's drops. Times
nothing: only the spans' names, nesting and order are checked."""
import collections

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")
counting = lazy("repro_torch.kernels.counting")
tf = lazy("repro_torch.core.frdc")
tg = lazy("repro_torch.models.gnn")
ENTRY_MODULES = ("bmm_kernel", "bspmm_kernel", "fused_layer", "pack_kernel")

N, F, HIDDEN, C = 96, 40, 16, 5
FORWARD_SPANS = {
    "gcn": {"gnn.forward": 1, "gnn.layer": 2, "bn": 1, "bmm.FBB": 1,
            "bspmm.BBB": 1, "bmm.BBF": 1, "bspmm.FBF": 1},
    "sage": {"gnn.forward": 1, "gnn.layer": 2, "bn": 2, "bin": 2,
             "bmm.BBF": 4, "bspmm.FBF": 2},
}


def fresh_ring(monkeypatch, size=None):
    r = counting.SpanRing() if size is None else counting.SpanRing(size)
    monkeypatch.setattr("repro_torch.kernels.counting.RING", r)
    return r


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(5)
    key = np.unique(rng.integers(0, N * N, 700))
    rows, cols = key // N, key % N
    x = torch.from_numpy(rng.standard_normal((N, F)).astype(np.float32))
    return x, rows, cols


def _model(family, graph):
    """A forward of ``family`` with BN frozen from one calibrating call."""
    x, rows, cols = graph
    if family == "gcn":
        m = tg.BitGCN(tg.init_gcn(1, F, HIDDEN, C, "cpu"), scheme="bin")
        adjs = (tf.gcn_normalized(rows, cols, N, device="cpu"),
                tf.from_coo(rows, cols, N, N, device="cpu"))
    else:
        m = tg.BitSAGE(tg.init_sage(1, F, HIDDEN, C, "cpu"))
        adjs = (tf.mean_normalized(rows, cols, N, device="cpu"),)
    _, stats = m(x, *adjs, return_bn_stats=True)
    return lambda: m(x, *adjs, bn_stats=stats)


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _entries():
    import importlib
    return sum(sum(importlib.import_module(
        f"repro_torch.kernels.{m}").ENTRIES.values()) for m in ENTRY_MODULES)


def test_profiler_flag_flips_under_the_profiler():
    from torch.autograd import profiler
    assert not profiler._is_profiler_enabled
    assert _profiled(lambda: profiler._is_profiler_enabled)
    assert not profiler._is_profiler_enabled


@pytest.mark.parametrize("family", ["gcn", "sage"])
def test_no_forward_spans_outside_a_profiler(monkeypatch, graph, family):
    forward = _model(family, graph)
    ring = fresh_ring(monkeypatch)
    forward()
    assert counting.spans() == [] and ring.dropped == 0


@pytest.mark.parametrize("family", ["gcn", "sage"])
def test_forward_span_tree(monkeypatch, graph, family):
    forward = _model(family, graph)
    fresh_ring(monkeypatch)
    entries = _entries()
    _profiled(lambda: (forward(), forward()))
    entries = _entries() - entries
    spans = counting.spans()
    by_index = {s.index: s for s in spans}
    roots = [s for s in spans if s.name == "gnn.forward"]
    assert len(roots) == 2 and len({s.forward for s in roots}) == 2
    assert sum(s.name.startswith("kernel.") for s in spans) == entries > 0
    for root in roots:
        assert root.parent == counting.NO_SPAN
        mine = [s for s in spans if s.forward == root.forward]
        names = collections.Counter(s.name for s in mine
                                    if not s.name.startswith("kernel."))
        assert names == FORWARD_SPANS[family]
        for s in mine:
            if s is root:
                continue
            p = by_index[s.parent]
            assert p.forward == root.forward
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
            if s.name == "gnn.layer":
                assert p is root
            if s.name.startswith("kernel."):
                assert not p.name.startswith("kernel.")


@pytest.mark.parametrize("family", ["gcn", "sage"])
def test_logits_bit_equal_with_spans_on_and_off(monkeypatch, graph,
                                                family):
    forward = _model(family, graph)
    fresh_ring(monkeypatch)
    off = forward()
    on = _profiled(forward)
    assert any(s.name == "gnn.forward" for s in counting.spans())
    assert torch.equal(on, off)


def test_frdc_build_spans_without_a_profiler(monkeypatch, graph):
    _, rows, cols = graph
    fresh_ring(monkeypatch)
    tf.gcn_normalized(rows, cols, N, device="cpu")
    spans = counting.spans()
    assert [s.name for s in spans] == ["frdc.tiles", "frdc.groups",
                                       "frdc.upload", "frdc.from_coo"]
    root = spans[-1]
    assert root.parent == counting.NO_SPAN
    assert root.forward == counting.NO_SPAN
    assert [s.parent for s in spans[:3]] == [root.index] * 3
    ends = [root.start_ns] + [t for s in spans[:3]
                              for t in (s.start_ns, s.end_ns)]
    assert ends == sorted(ends) and ends[-1] <= root.end_ns


def test_ring_drops_the_oldest_and_counts_them(monkeypatch):
    ring = fresh_ring(monkeypatch, 3)
    for i in range(5):
        with counting.setup_span(f"s{i}"):
            pass
    assert [s.name for s in counting.spans()] == ["s2", "s3", "s4"]
    assert ring.dropped == 2
    idx = [s.index for s in counting.spans()]
    assert idx == sorted(idx) and len(set(idx)) == 3
