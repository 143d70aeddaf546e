"""The readers of the port's spans (``portbench/spans.py``) on hand-made
spans beside the hand-made window of ``test_portbench_trace.py``: self
time, the exact overlap with the device's idle time, the window filter,
the outermost spans, and nothing to read outside a traced run on the card
or where the port records no spans."""
import pytest

from portbench import harness, spans
from portbench.trace import Trace

from .test_portbench_trace import MS, ctx, trace

COUNTING = "repro_torch.kernels.counting"


def made_spans():
    from repro_torch.kernels.counting import NO_SPAN, Span
    out = []

    def add(name, start, end, parent=NO_SPAN, forward=NO_SPAN):
        out.append(Span(len(out), name, parent, forward, int(start * MS),
                        int(end * MS)))
        return len(out) - 1
    # set-up before the window (0-10 ms): builds of 40 ms (one nested in
    # it) and 30 ms
    b = add("frdc.from_coo", -100, -60)
    add("frdc.from_coo", -90, -70, b)
    b = add("frdc.from_coo", -50, -20)
    add("frdc.tiles", -45, -30, b)
    # forward 1 in the first enqueue (0-1), forward 2 in the second (5-6)
    f = add("gnn.forward", 0.1, 0.9, forward=1)
    k = add("kernel.bspmm_fp", 0.2, 0.4, f, 1)
    add("kernel.binarize_pack", 0.25, 0.3, k, 1)   # not outermost
    add("bn", 0.5, 0.6, f, 1)
    f = add("gnn.forward", 5.0, 6.0, forward=2)
    add("kernel.bmm_xnor", 5.5, 5.8, f, 2)
    # a kernel call outside any forward, and a forward past the window
    add("kernel.bmm_xnor", 1.2, 1.3)
    f = add("gnn.forward", 10.5, 11.0, forward=3)
    add("kernel.bmm_xnor", 10.6, 10.7, f, 3)
    return out


@pytest.fixture
def port_spans(monkeypatch):
    made = made_spans()
    monkeypatch.setattr(f"{COUNTING}.spans", lambda: made)
    return made


def read(name, c):
    return harness.read_metric(name, c)


def test_readers_on_made_spans(port_spans):
    c = ctx(trace())
    # forwards 0.1-0.9 and 5-6; outermost kernel calls 0.2-0.4, 5.5-5.8
    assert read("kernel_calls_host_ms", c) == pytest.approx(0.5 / 2)
    # blocks 0.1-0.2, 0.4-0.9, 5-5.5, 5.8-6
    assert read("blocks_host_ms", c) == pytest.approx(1.3 / 2)
    # idle 0-0.5, 4-6, 9-10: overlaps 0.1 + 0.1 + 0.5 + 0.2
    assert read("idle_blocks_ms", c) == pytest.approx(0.9 / 2)
    assert read("setup_frdc_s", c) == pytest.approx(0.07)
    for name in ("kernel_calls_host_ms", "blocks_host_ms", "idle_blocks_ms"):
        assert read(f"hostpaced_{name}", c) == read(name, c)


def test_window_filter(port_spans):
    # a window that opens at 5 ms: forward 1 and the builds drop out of
    # the forward metrics; the builds still end before it opens
    t = trace()._replace(start_ns=5 * MS, forwards=1)
    c = ctx(t)
    assert read("kernel_calls_host_ms", c) == pytest.approx(0.3)
    assert read("blocks_host_ms", c) == pytest.approx(0.7)
    assert read("setup_frdc_s", c) == pytest.approx(0.07)
    # a window with no forward in it
    c = ctx(trace()._replace(start_ns=7 * MS))
    assert read("blocks_host_ms", c) is None
    assert read("setup_frdc_s", c) == pytest.approx(0.07)


def test_nothing_outside_a_traced_run_on_the_card(port_spans):
    cpu = Trace(device_ops=[], spans=trace().spans, forwards=2, start_ns=0,
                end_ns=10 * MS)
    for c in (ctx(), ctx(cpu)):
        for name in ("kernel_calls_host_ms", "blocks_host_ms",
                     "idle_blocks_ms", "setup_frdc_s"):
            assert read(name, c) is None


def test_nothing_where_the_port_records_no_spans(monkeypatch):
    monkeypatch.delattr(f"{COUNTING}.spans")
    c = ctx(trace())
    for name in ("kernel_calls_host_ms", "blocks_host_ms", "idle_blocks_ms",
                 "setup_frdc_s"):
        assert read(name, c) is None


@pytest.mark.parametrize("a,b,rest,common", [
    ([(0, 10)], [(2, 3), (5, 7)], [(0, 2), (3, 5), (7, 10)], 3),
    ([(0, 4), (6, 10)], [(3, 7)], [(0, 3), (7, 10)], 2),
    ([(2, 3)], [(0, 10)], [], 1),
    ([(0, 5)], [], [(0, 5)], 0),
])
def test_interval_arithmetic(a, b, rest, common):
    assert spans.subtract(a, b) == rest
    assert spans.overlap_ns(a, b) == spans.overlap_ns(b, a) == common
    assert spans.union([(5, 7), (0, 2), (1, 3), (9, 9)]) == [(0, 3), (5, 7)]
