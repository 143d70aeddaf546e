"""fc (BN -> quantize_act -> BMM.BBF, SAINT's last layer) as its own
ordinary launch over rows, ``fused_fc`` in ``csrc/fused_layer.cu``,
checked here without a card:

* the kernel's plain mirror ``fused_layer.fc_rows_plain`` against the
  reference's fc step, ``bmm(quantize_act(bn(h)), w_fc, "BBF")``
  (``models/gnn.py``), with BN by the division (``batch_norm``) and by the
  reciprocal (``session_core.apply_bn``), on seeded N(0, 1) inputs at f in
  {64, 65, 500} and ho in {7, 41}: sign words equal, outputs within 1e-5
  of |output| (the reference takes the row's mean |z| in another order);
  packed input words with unit scales bit-equal;
* the mirror's row scale against the kernel's lane order written out in
  numpy (lane partials in chunk order, then the xor butterfly), bit for
  bit;
* the C interface: ``_FcParams`` against ``FcParams``, the exported
  functions against ``build.SIGNATURES``, and no cooperative launch, grid
  barrier or shared-memory opt-in on fc's path; the widths and inputs the
  wrapper refuses;
* what the entry points launch, with the library replaced by a recorder:
  fc in both forms calls ``fused_fc`` (sd, or its reciprocal), the three
  aggregating kinds and the sharded transform still call ``fused_layer``,
  and the counters count as before.
"""
import ctypes
import re
from pathlib import Path

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bmm as jbmm  # noqa: E402
from repro.core.binarize import BinTensor as JBin  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve import session_core as jsc  # noqa: E402
tbin = lazy("repro_torch.core.binarize")
tbitops = lazy("repro_torch.core.bitops")
tf = lazy("repro_torch.core.frdc")
tfl = lazy("repro_torch.kernels.fused_layer")
tbuild = lazy("repro_torch.kernels.build")

jax.config.update("jax_platform_name", "cpu")

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
ROWS = 70                         # not a multiple of a block's 32 rows
FP_TOL, FP_TOL_ABS = 1e-5, 1e-6


def _case(rng, f, ho, rows=ROWS):
    """Seeded x, BN stats and fp weights (numpy), and the weights quantized
    by the reference, in both packages: (x, mu, sd, jax W, port W)."""
    x = rng.standard_normal((rows, f)).astype(np.float32)
    mu = (0.1 * rng.standard_normal((1, f))).astype(np.float32)
    sd = rng.uniform(0.5, 2.0, (1, f)).astype(np.float32)
    jw = jbmm.quantize_weight(jnp.asarray(
        rng.standard_normal((f, ho)).astype(np.float32)))
    tw = tbin.BinTensor(torch.from_numpy(np.array(jw.packed).view(np.int32)),
                        torch.from_numpy(np.array(jw.scale)), f)
    return x, mu, sd, jw, tw


@pytest.mark.parametrize("ho", [7, 41])
@pytest.mark.parametrize("f", [64, 65, 500])
def test_fc_rows_plain_matches_reference(f, ho):
    """Both BN forms: the mirror's sign words equal the reference's
    quantize_act words, its row scales and outputs are within 1e-5 of the
    reference's quantize_act and fc step."""
    rng = np.random.default_rng(f * 100 + ho)
    x, mu, sd, jw, tw = _case(rng, f, ho)
    bn = (torch.from_numpy(mu), torch.from_numpy(sd))
    for rcp in (False, True):
        z = jsc.apply_bn(x, mu, sd) if rcp else \
            jg.batch_norm(jnp.asarray(x), stats=(mu, sd))
        q = jbmm.quantize_act(z)
        want = np.asarray(jbmm.bmm(q, jw, "BBF"))
        words, scale = tfl._fc_rows_input(torch.from_numpy(x), bn, rcp)
        assert np.array_equal(words.numpy().view(np.uint32),
                              np.asarray(q.packed)), (f, ho, rcp)
        assert np.allclose(scale.numpy(), np.asarray(q.scale), rtol=FP_TOL,
                           atol=0)
        got = tfl.fc_rows_plain(torch.from_numpy(x), bn, tw, rcp).numpy()
        assert got.shape == want.shape == (ROWS, ho)
        assert bool((np.abs(got - want)
                     <= FP_TOL * np.abs(want) + FP_TOL_ABS).all()), (f, ho, rcp)


def test_fc_rows_plain_packed_words_match_reference():
    """int32 rows are sign words with unit scales: the mirror, fc_plain and
    the reference's BMM.BBF agree bit for bit."""
    rng = np.random.default_rng(3)
    f, ho = 65, 41
    _, _, _, jw, tw = _case(rng, f, ho)
    bits = rng.integers(0, 2, (ROWS, f))
    h = tbitops.pack_bits(torch.from_numpy(bits))
    jq = JBin(jnp.asarray(h.numpy().view(np.uint32)),
              jnp.ones((ROWS, 1), jnp.float32), f)
    want = np.asarray(jbmm.bmm(jq, jw, "BBF"))
    got = tfl.fc_rows_plain(h, None, tw)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, tfl.fc_plain(h, None, tw))


def _lane_scales(z: np.ndarray) -> np.ndarray:
    """The kernel's row scale, lane by lane in float32: lane l adds |z| of
    features l, 32 + l, ... in turn; v += v[l ^ o] for o = 16 .. 1; / f."""
    n, f = z.shape
    out = np.empty((n, 1), np.float32)
    for r in range(n):
        v = np.zeros(32, np.float32)
        for k in range(f):
            v[k % 32] = np.float32(v[k % 32] + np.abs(z[r, k]))
        for o in (16, 8, 4, 2, 1):
            v = (v + v[np.arange(32) ^ o]).astype(np.float32)
        out[r, 0] = np.float32(v[0] / np.float32(f))
    return out


def test_lane_row_scale_is_the_kernels_order():
    """The mirror's row scale equals the lane order written out, bit for
    bit, at widths of one chunk, a ragged chunk and many chunks; the mean
    of fc_plain sums in another order and differs on some rows."""
    rng = np.random.default_rng(5)
    differs = 0
    for f in (7, 32, 65, 500):
        z = rng.standard_normal((40, f)).astype(np.float32)
        got = tfl._lane_row_scale(torch.from_numpy(z)).numpy()
        assert np.array_equal(got, _lane_scales(z)), f
        mean = torch.from_numpy(z).abs().mean(dim=-1, keepdim=True).numpy()
        differs += int((got != mean).sum())
    assert differs > 0


def _ctype(decl: str):
    if "*" in decl:
        return tbuild._P
    return tbuild._L if "long long" in decl else tbuild._I


def test_fc_params_and_launch_mirror_source():
    """``_FcParams`` has the fields of ``FcParams`` in order; the source
    exports ``fused_fc`` and ``fused_fc_attrs`` as ``build.SIGNATURES``
    binds them; and fc's kernel and launcher hold no cooperative launch,
    grid barrier, occupancy query or shared-memory opt-in."""
    text = (CSRC / "fused_layer.cu").read_text()
    body = re.search(r"struct FcParams \{(.*?)\n\};", text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if decl:
            fields.append((re.match(r".*?(\w+);$", decl).group(1),
                           _ctype(decl)))
    assert fields == list(tfl._FcParams._fields_)
    found = {name: tuple(_ctype(p) for p in params.split(","))
             for name, params in re.findall(
                 r'extern "C" int (\w+)\(([^)]*)\)', text)}
    sig = tbuild.SIGNATURES["fused_layer"]
    assert found == sig
    assert sig["fused_fc"] == (tbuild._P, tbuild._P)
    assert sig["fused_fc_attrs"] == (tbuild._I, tbuild._P)
    kernel = text[text.index("struct FcParams"):text.index("}  // namespace")]
    launcher = text[text.index('extern "C" int fused_fc('):
                    text.index('extern "C" int fused_fc_attrs(')]
    for part in (kernel, launcher):
        for banned in ("cudaLaunchCooperativeKernel", "grid.sync",
                       "this_grid", "cudaFuncSetAttribute", "allow_smem",
                       "resident_blocks"):
            assert banned not in part, banned
    assert "cudaLaunchKernel" in launcher


def test_fc_launch_refuses_what_the_kernel_does_not_take(monkeypatch):
    """fc's wrapper refuses, before any launch, widths past the kernel's
    (4,096 features, 256 outputs), rows whose width is not the weights',
    and rows that are neither float32 nor int32 words."""
    import repro_torch.kernels.build as build
    rec = _Recorder()
    monkeypatch.setattr(build, "library", lambda name: rec)

    def weights(ho, f):
        return tbin.BinTensor(torch.zeros((ho, -(-f // 32)),
                                          dtype=torch.int32),
                              torch.ones((ho, 1)), f)
    x = torch.zeros((5, 64))
    with pytest.raises(ValueError, match="beyond the kernel"):
        tfl._fc_launch(torch.zeros((5, 4097)), None, weights(7, 4097))
    with pytest.raises(ValueError, match="beyond the kernel"):
        tfl._fc_launch(x, None, weights(257, 64))
    with pytest.raises(ValueError, match="does not match"):
        tfl._fc_launch(x, None, weights(7, 65))
    with pytest.raises(ValueError, match="does not match"):
        tfl._fc_launch(torch.zeros((5, 64), dtype=torch.int32), None,
                       weights(7, 64))
    with pytest.raises(ValueError, match="float32 rows or int32 words"):
        tfl._fc_launch(x.double(), None, weights(7, 64))
    assert rec.calls == []


class _Recorder:
    """Stands in for the built library: keeps each launch's entry, a copy
    of its struct and of the BN sd values it points to."""

    def __init__(self):
        self.calls = []

    def _record(self, entry, struct, params):
        p = struct.from_buffer_copy(params._obj)
        sd = None if p.sd is None else np.ctypeslib.as_array(
            (ctypes.c_float * p.f).from_address(p.sd)).copy()
        self.calls.append((entry, p, sd))
        return 0

    def fused_layer(self, params, stream):
        return self._record("fused_layer", tfl._Params, params)

    def fused_fc(self, params, stream):
        return self._record("fused_fc", tfl._FcParams, params)


def test_fc_launches_its_own_kernel(monkeypatch):
    """On the card (``_on_card`` patched, the library a recorder) fc with
    and without ``bn_rcp``, and on packed words, is one ``fused_fc`` launch
    with its input, BN, weights and output in the struct; ``transform`` and
    the three aggregating kinds still launch ``fused_layer``. Every call is
    one fused-layer entry and one ``fused_layer`` launch, ``fc+rcp``
    counts the reciprocal form, and fc counts one fused layer and no
    aggregation, as before."""
    import repro_torch.kernels.build as build
    import repro_torch.kernels.fused_layer as fl_mod
    import torch as torch_mod
    rec = _Recorder()
    monkeypatch.setattr(build, "library", lambda name: rec)
    monkeypatch.setattr(torch_mod.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(fl_mod, "_on_card", lambda t: True)
    rng = np.random.default_rng(8)
    n, f = 40, 64
    x, mu, sd, _, w = _case(rng, f, 7, rows=n)
    x = torch.from_numpy(x)
    bn = (torch.from_numpy(mu), torch.from_numpy(sd))
    w64 = tbin.BinTensor(tbitops.pack_bits(torch.from_numpy(
        rng.integers(0, 2, (64, f)))), torch.ones((64, 1)), f)
    src, dst = rng.integers(0, n, 4 * n), rng.integers(0, n, 4 * n)
    adj = tf.gcn_normalized(src, dst, n, device="cpu")
    adj01 = tf.from_coo(src, dst, n, n, device="cpu")
    hw = tbitops.pack_bits(torch.from_numpy(rng.integers(0, 2, (n, f))))
    counters = (tfl.LAUNCHES, tfl.ENTRIES, tfl.KERNEL_CALLS)
    before = [dict(c) for c in counters]

    out = tfl.fc(x, bn, w)
    entry, p, got_sd = rec.calls[-1]
    assert entry == "fused_fc" and p.bn_rcp == 0 and p.xw is None
    assert (p.x, p.out, p.w_a) == (x.data_ptr(), out.data_ptr(),
                                   w.packed.data_ptr())
    assert (p.n_in, p.f, p.wk, p.ho) == (n, f, 2, 7)
    assert tuple(out.shape) == (n, 7) and out.dtype == torch.float32
    assert np.array_equal(got_sd, sd.ravel())
    tfl.fc(x, bn, w, bn_rcp=True)
    entry, p, got_sd = rec.calls[-1]
    assert entry == "fused_fc" and p.bn_rcp == 1
    # the struct's sd is the reciprocal the plain versions take
    assert np.array_equal(got_sd, (1.0 / bn[1]).numpy().ravel())
    tfl.fc(hw, None, w)
    entry, p, got_sd = rec.calls[-1]
    assert entry == "fused_fc" and p.xw == hw.data_ptr()
    assert p.x is None and p.mu is None and got_sd is None

    tfl.transform(x, bn, w, bn_rcp=True)
    tfl.gcn_bin_l1(x, bn, w64, adj01)
    tfl.gcn_bbf_fbf(x, bn, w, adj, relu=True)
    tfl.branch_add(x, bn, w, w, adj, relu=True)
    entries = [e for e, _, _ in rec.calls]
    assert entries == ["fused_fc"] * 3 + ["fused_layer"] * 4
    assert [p.aggregate for _, p, _ in rec.calls[3:]] == [0, 1, 1, 1]
    assert rec.calls[4][1].fbb == 1

    moved = [{k: c[k] - b[k] for k in c if c[k] != b[k]}
             for c, b in zip(counters, before)]
    assert moved[0] == {"fused_layer": 7, "fused_layer/fc+rcp": 1,
                        "fused_layer/transform": 1}
    assert moved[1] == {"fused_layer": 7}
    assert moved[2] == {"fused": 6, "fused_aggs": 3}
