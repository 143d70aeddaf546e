"""The reductions of a trace and the metric readers, on hand-made
timelines and windows."""
import pytest

from portbench import counts, harness
from portbench.trace import Trace

MS = 1_000_000  # ns


def trace():
    # window 0-10 ms, two forwards: enqueue 0-1, sync 1-5, enqueue 5-6,
    # sync 6-10; device ops 0.5-2 (agg), 1.5-4 (gemm), 6-9 (other)
    return Trace(
        device_ops=[("bspmm_fp_kernel<1>", int(0.5 * MS), 2 * MS),
                    ("sm80_xmma_gemm_f32", int(1.5 * MS), 4 * MS),
                    ("elementwise_kernel", 6 * MS, 9 * MS)],
        spans=[("portbench.enqueue", 0, MS), ("portbench.sync", MS, 5 * MS),
               ("portbench.enqueue", 5 * MS, 6 * MS),
               ("portbench.sync", 6 * MS, 10 * MS)],
        forwards=2, start_ns=0, end_ns=10 * MS)


def test_union_busy_and_gaps():
    t = trace()
    assert t.intervals() == [(int(0.5 * MS), 4 * MS), (6 * MS, 9 * MS)]
    assert t.busy_s == pytest.approx(6.5e-3)
    gaps = dict((n, 0.0) for n in ("enqueue", "sync"))
    for name, sec in t.gaps():
        gaps[name] += sec
    # 0-0.5 in enqueue; 4-6 (mid 5) at the second enqueue's start; 9-10 sync
    assert gaps == pytest.approx({"enqueue": 2.5e-3, "sync": 1e-3})
    b = t.breakdown()
    assert b["device_ops"][0] == ["elementwise_kernel", 3e-3]
    assert ["enqueue (total)", pytest.approx(2.5e-3)] in b["idle_gaps"]


def ctx(tr=None):
    s = {"n": 8, "f": 32, "h": 32, "c": 4, "nnz": 20, "tiles": 6,
         "nnz_hat": 28, "tiles_hat": 8}
    from portbench.counts import gcn_bin
    return harness.Context(
        setup_s=12.5, window={"count": 4, "window_s": 0.02,
                              "latencies_s": [0.004, 0.005, 0.006, 0.005],
                              "enqueue_s": [0.001, 0.002, 0.001, 0.002]},
        peak_bytes=5_000_000, stages=gcn_bin.stages(s), trace=tr)


def read(name, c):
    return harness.read_metric(name, c)


def test_end_to_end_readers():
    c = ctx()
    assert read("forward_ms", c) == pytest.approx(5.0)
    assert read("forward_p95_ms", c) == pytest.approx(6.0)
    assert read("peak_mem_mb", c) == pytest.approx(5.0)
    assert read("setup_s", c) == 12.5


def test_per_layer_readers():
    c = ctx(trace())
    assert read("host_enqueue_ms", c) == pytest.approx(1.5)
    assert read("device_launches", c) == 1.5
    assert read("idle_share", c) == pytest.approx(35.0)
    assert read("blocks_device_ms", c) == pytest.approx(1.5)
    agg = counts.stage_least_seconds(c.stages["aggregation"])
    assert read("agg_roofline", c) == pytest.approx(agg / 0.75e-3 * 100)
    xf = counts.stage_least_seconds(c.stages["transform"])
    assert read("xform_roofline", c) == pytest.approx(xf / 1.25e-3 * 100)
    mfu = counts.peak_seconds(c.stages) / 5e-3 * 100
    assert read("forward_mfu", c) == pytest.approx(mfu)


def test_same_as_reads_the_other_metric():
    c = ctx(trace())
    assert read("hostpaced_forward_ms", c) == read("forward_ms", c)
    assert read("hostpaced_agg_roofline", c) == read("agg_roofline", c)


def test_device_readers_find_nothing_without_a_trace():
    c = ctx()
    for name in ("device_launches", "idle_share", "blocks_device_ms",
                 "agg_roofline", "xform_roofline"):
        assert read(name, c) is None
