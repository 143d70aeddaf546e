"""counts/: operations and bytes against hand-worked shapes."""
import pytest

from portbench import counts
from portbench.counts import gcn_bin, sage

S = {"n": 8, "f": 32, "h": 32, "c": 4, "nnz": 20, "tiles": 6,
     "nnz_hat": 28, "tiles_hat": 8}


def by_name(stages):
    return {o.name: o for ops in stages.values() for o in ops}


def test_adjacency_bytes_takes_the_smaller_form():
    # CSR 4*20 + 4*9 = 116; tiles 6*6 + 4*(2+1) = 48
    assert counts.adjacency_bytes(8, 20, 6) == 48
    # tiles 100*6 + 12 = 612 > CSR 116; two scale vectors add 2*4*8
    assert counts.adjacency_bytes(8, 20, 100, scales=2) == 116 + 64


def test_gcn_bin_stages():
    ops = by_name(gcn_bin.stages(S))
    assert ops["bmm_fbb1"].ops == 2 * 8 * 32 * 32
    assert ops["bmm_fbb1"].rate == "fp32"
    # BN(x) 8x32 fp32, W1 signs 32x32 bits, its 32 scales, out 8x32 bits
    assert ops["bmm_fbb1"].bytes == 1024 + 128 + 128 + 32
    assert ops["bmm_bbf2"].ops == 2 * 8 * 32 * 4
    assert ops["bmm_bbf2"].rate == "int8"
    assert ops["bmm_bbf2"].bytes == 32 + 16 + 16 + 128
    assert ops["bspmm_bbb1"].ops == 2 * 20 * 32
    assert ops["bspmm_bbb1"].bytes == 32 + 48 + 32
    # A + I: tiles 8*6 + 12 = 60 beat CSR 4*28 + 36 = 148; two scales 64
    assert ops["bspmm_fbf2"].ops == 2 * 28 * 4
    assert ops["bspmm_fbf2"].bytes == 128 + (60 + 64) + 128
    assert ops["bn1"].ops == 2 * 8 * 32


def test_sage_stages():
    ops = by_name(sage.stages(S))
    assert ops["bmm_self1"].ops == ops["bmm_agg1"].ops == 2 * 8 * 32 * 32
    assert ops["bmm_self2"].ops == 2 * 8 * 32 * 4
    assert ops["bspmm_fbf1"].ops == 2 * 20 * 32
    # in 8x32 fp32, A (tiles 48) + its row scales 32, out 8x32 fp32
    assert ops["bspmm_fbf1"].bytes == 1024 + 48 + 32 + 1024
    assert ops["bin1"].bytes == 1024 + 32
    assert ops["add1"].ops == 2 * 8 * 32 and ops["add2"].ops == 8 * 4


def test_least_and_peak_seconds():
    p = counts.PEAKS
    op = counts.Op("x", 2e12, "fp32", 3.35e9)
    assert counts.least_seconds(op) == pytest.approx(max(2e12 / p["fp32"],
                                                         3.35e9 / p["hbm_bytes"]))
    st = {"a": [op], "b": [counts.Op("y", 1.979e12, "int8", 0.0)]}
    assert counts.peak_seconds(st) == pytest.approx(2e12 / 6.7e13 + 1e-3)
    assert counts.stage_least_seconds(st["a"] + st["b"]) == pytest.approx(
        counts.least_seconds(op) + 1e-3)
