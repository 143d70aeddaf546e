"""The fused layer's intra+halo pair body (the sharded executors' step) of
the port against the reference's.

* The plain pair stages ``agg_fp_pair`` and ``agg_counts_pair`` against the
  reference's ``agg_fp_pair`` and ``agg_counts(intra) + agg_counts(halo)``
  run through ``fused_call`` (Pallas, interpret mode), on a rectangular
  (n_local_pad x n_halo_pad) halo adjacency with hub rows, with an empty
  halo and an empty shard: counts bit-exact, fp at 1e-5.
* Each family's layer steps in their one-launch form (``LayerStep.fused``,
  the plain versions here) against the reference's
  ``executor._fused_layer_compute`` of the same step in interpret mode, on
  inputs whose transform sums are exact in any order: packed words
  bit-exact, fp within 1e-5 of the sum of |terms|.
* The C interface: ``_Params`` against ``Params`` in ``csrc/fused_layer.cu``
  and the exported functions against ``build.SIGNATURES``; what the
  wrapper puts in the struct for a pair launch (halo arrays, the
  reciprocal of sd, scratch for the intra and halo items), with the
  library replaced by a recorder; and the pair arguments it refuses.
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

from repro.core import binarize as jbin, frdc as jf  # noqa: E402
from repro.kernels import fused_layer as jfl  # noqa: E402
from repro.models import gnn as jg  # noqa: E402
from repro.serve import session_core as jsc  # noqa: E402
from repro.serve.sharded import executor as jex  # noqa: E402
tf = lazy("repro_torch.core.frdc")
tbin = lazy("repro_torch.core.binarize")
tfl = lazy("repro_torch.kernels.fused_layer")
tbuild = lazy("repro_torch.kernels.build")
tbk = lazy("repro_torch.kernels.bspmm_kernel")
tg = lazy("repro_torch.models.gnn")
tsc = lazy("repro_torch.serve.session_core")

jax.config.update("jax_platform_name", "cpu")

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
ROWS, HALO, PAD_ROWS, PAD_HALO = 45, 27, 48, 32
FP_TOL, FP_TOL_ABS = 1e-5, 1e-6


def _coo(rng, rows, cols, p, hub=None):
    a = (rng.random((rows, cols)) < p).astype(np.float32)
    if hub is not None:
        a[hub, :] = 1.0            # a tile-row of many groups
    return a


def _pair(rng, scaled=True, intra_p=0.2, halo_p=0.15):
    """The same shard's (intra, halo) in both packages, padded as the
    executors pad them: ((jax intra, jax halo), (port intra, port halo))."""
    a = _coo(rng, ROWS, ROWS, intra_p, hub=2)
    h = _coo(rng, ROWS, HALO, halo_p, hub=3 if halo_p else None)
    sr = rng.random(ROWS) + 0.5 if scaled else None
    sh = rng.random(HALO) + 0.5 if scaled else None
    kw_a = dict(row_scale=sr, col_scale=sr) if scaled else {}
    kw_h = dict(row_scale=sr, col_scale=sh) if scaled else {}
    ja = jf.pad_frdc(jf.from_dense(a, **kw_a), PAD_ROWS, PAD_ROWS, n_groups=40)
    jh = jf.pad_frdc(jf.from_dense(h, **kw_h), PAD_ROWS, PAD_HALO,
                     n_groups=30)
    ta = tf.pad_frdc(tf.from_dense(a, device="cpu", **kw_a), PAD_ROWS,
                     PAD_ROWS, n_groups=40)
    th = tf.pad_frdc(tf.from_dense(h, device="cpu", **kw_h), PAD_ROWS,
                     PAD_HALO, n_groups=30)
    return (ja, jh), (ta, th)


def _in_kernel(fn, ja, jh, *xs):
    """Run ``fn(intra, halo, *xs)`` inside one reference ``fused_call``
    (interpret mode), the FRDC matrices crossing as their arrays."""
    dims = (ja.n_rows, ja.n_cols, jh.n_rows, jh.n_cols)

    def body(ia, ha, *vals):
        return fn(jsc.frdc_rebuild(ia, dims[0], dims[1]),
                  jsc.frdc_rebuild(ha, dims[2], dims[3]), *vals)
    return np.asarray(jfl.fused_call(body, jsc.frdc_arrays(ja),
                                     jsc.frdc_arrays(jh), *xs,
                                     interpret=True))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_agg_fp_pair_matches_reference():
    rng = np.random.default_rng(31)
    (ja, jh), (ta, th) = _pair(rng)
    xl = rng.standard_normal((PAD_ROWS, 24)).astype(np.float32)
    xr = rng.standard_normal((PAD_HALO, 24)).astype(np.float32)
    want = _in_kernel(jfl.agg_fp_pair, ja, jh, jnp.asarray(xl),
                      jnp.asarray(xr))
    got = tfl.agg_fp_pair(ta, th, _t(xl), _t(xr)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the row scale is applied once, after the add
    raw = tfl.agg_fp(ta._replace(row_scale=None), _t(xl)) \
        + tfl.agg_fp(th._replace(row_scale=None), _t(xr))
    assert torch.equal(_t(got), raw * ta.row_scale[:, None])


@pytest.mark.parametrize("mode", ["s3_two_popc", "s2_and_andnot"])
def test_counts_pair_matches_reference(mode):
    rng = np.random.default_rng(32)
    (ja, jh), (ta, th) = _pair(rng, scaled=False)
    xl = np.asarray(jax.random.bits(jax.random.PRNGKey(1), (PAD_ROWS, 2),
                                    jnp.uint32))
    xr = np.asarray(jax.random.bits(jax.random.PRNGKey(2), (PAD_HALO, 2),
                                    jnp.uint32))

    def ref(a, h, xa, xb):
        return jfl.agg_counts(a, xa, mode) + jfl.agg_counts(h, xb, mode)
    want = _in_kernel(ref, ja, jh, jnp.asarray(xl), jnp.asarray(xr))
    got = tfl.agg_counts_pair(ta, th, _t(xl.view(np.int32)),
                              _t(xr.view(np.int32)), mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["empty_halo", "empty_shard"])
def test_pair_without_halo_edges(case):
    """A shard whose rows have no remote neighbour (the halo matrix is one
    zero group), and one with no edge at all: the pair equals the intra
    aggregation alone, and the reference's."""
    rng = np.random.default_rng(33)
    (ja, jh), (ta, th) = _pair(rng, halo_p=0.0,
                               intra_p=0.2 if case == "empty_halo" else 0.0)
    if case == "empty_shard":
        (ja, _), (ta, _) = _pair(rng, intra_p=0.0, halo_p=0.0)
        ja = ja._replace(tiles=jnp.zeros_like(ja.tiles))
        ta = ta._replace(tiles=torch.zeros_like(ta.tiles))
    xl = rng.standard_normal((PAD_ROWS, 7)).astype(np.float32)
    xr = rng.standard_normal((PAD_HALO, 7)).astype(np.float32)
    got = tfl.agg_fp_pair(ta, th, _t(xl), _t(xr))
    want = _in_kernel(jfl.agg_fp_pair, ja, jh, jnp.asarray(xl),
                      jnp.asarray(xr))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), tfl.agg_fp(ta, _t(xl)).numpy(),
                               rtol=1e-6, atol=1e-6)


def _quant(rng, family, f, h, c):
    """Quantized weights with power-of-two scales in both packages."""
    shapes = {"gcn": [(h, f), (c, h)],
              "sage": [(h, f), (h, f), (c, h), (c, h)],
              "saint": [(h, f), (h, f), (h, h), (h, h), (c, h)]}[family]
    jw, tw = [], []
    for n_out, n_in in shapes:
        words = np.array(jax.random.bits(
            jax.random.PRNGKey(int(rng.integers(1 << 30))),
            (n_out, -(-n_in // 32)), jnp.uint32))
        tail = n_in % 32
        if tail:
            words[:, -1] &= np.uint32((1 << tail) - 1)
        scale = rng.choice([0.25, 0.5, 1.0], (n_out, 1)).astype(np.float32)
        jw.append(jbin.BinTensor(jnp.asarray(words), jnp.asarray(scale), n_in))
        tw.append(tbin.BinTensor(_t(words.view(np.int32)), _t(scale), n_in))
    cls = {"gcn": "GCNQuant", "sage": "SAGEQuant", "saint": "SAINTQuant"}
    return getattr(jg, cls[family])(*jw), getattr(tg, cls[family])(*tw)


CONFIGS = [("gcn", "bin"), ("gcn", "full"), ("sage", "fixed"),
           ("saint", "fixed")]


@pytest.mark.parametrize("family,scheme", CONFIGS)
def test_fused_steps_match_reference(family, scheme):
    """Every step of the family's layer program, fused with its halo pair
    (BN by the reciprocal), against the reference's one-launch step."""
    rng = np.random.default_rng(34)
    f, h, c = 40, 16, 5
    jq, tq = _quant(rng, family, f, h, c)
    variants = (jsc.GCN_SCHEME_VARIANTS[scheme] if family == "gcn"
                else jsc.FIXED_VARIANTS)
    jprog = jsc.build_layer_program(
        jsc.SessionPlan(family, scheme, layer_variants=variants), jq)
    tprog = tsc.build_layer_program(
        tsc.SessionPlan(family, scheme, layer_variants=variants), tq)
    assert [(s.name, s.kind, s.packed, s.bn_site, s.payload_cols)
            for s in jprog] == [(s.name, s.kind, s.packed, s.bn_site,
                                 s.payload_cols) for s in tprog]
    width = f
    for js, ts in zip(jprog, tprog):
        scaled = js.kind in ("adj", "mean")
        (ja, jh), (ta, th) = _pair(rng, scaled=scaled)
        if js.kind == "mean":      # SAGE: row scale only
            ja, jh = ja._replace(col_scale=None), jh._replace(col_scale=None)
            ta, th = ta._replace(col_scale=None), th._replace(col_scale=None)
        if width == -1:            # GCN "bin" layer 2: the packed carry
            st = np.array(jax.random.bits(jax.random.PRNGKey(5),
                                            (PAD_ROWS, 1), jnp.uint32))
            st &= np.uint32((1 << h) - 1)
            jst, tst = jnp.asarray(st), _t(st.view(np.int32))
        else:
            st = rng.integers(-3, 4, (PAD_ROWS, width)).astype(np.float32)
            jst, tst = jnp.asarray(st), _t(st)
        bn = None
        if js.bn_site is not None:
            mu = rng.integers(-1, 2, (1, width)).astype(np.float32)
            sd = rng.choice([1.0, 2.0], (1, width)).astype(np.float32)
            bn = (mu, sd)
        rem = None
        if js.kind is not None:
            if js.packed:
                rem = np.asarray(jax.random.bits(
                    jax.random.PRNGKey(6), (PAD_HALO, js.payload_cols),
                    jnp.uint32)) & np.uint32((1 << h) - 1)
            else:
                rem = rng.integers(-3, 4, (PAD_HALO, js.payload_cols)
                                   ).astype(np.float32)
        want = np.asarray(jex._fused_layer_compute(
            js, "s3_two_popc", jst,
            None if bn is None else tuple(map(jnp.asarray, bn)),
            None if rem is None else jnp.asarray(rem), ja, jh))
        trem = None if rem is None else _t(rem.view(np.int32) if js.packed
                                           else rem)
        got = ts.fused(tst, None if bn is None else tuple(map(_t, bn)), trem,
                       ta, th, (None, None)).numpy()
        if js.packed:
            np.testing.assert_array_equal(got.view(np.uint32), want,
                                          err_msg=js.name)
            width = -1
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=js.name)
            width = got.shape[1]


def _ctype(decl: str):
    if "*" in decl:
        return tbuild._P
    return tbuild._L if "long long" in decl else tbuild._I


def test_params_and_signature_mirror_source():
    """``_Params`` has the fields of ``Params`` in ``csrc/fused_layer.cu``
    in order, the pair's among them, and the source exports what
    ``build.SIGNATURES`` binds."""
    text = (CSRC / "fused_layer.cu").read_text()
    body = re.search(r"struct Params \{(.*?)\n\};", text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if decl:
            fields.append((re.match(r".*?(\w+);$", decl).group(1),
                           _ctype(decl)))
    assert fields == list(tfl._Params._fields_)
    names = [n for n, _ in fields]
    pair = ["h_grp_ptr", "h_tiles", "h_col_idx", "h_item_ptr", "h_col_scale",
            "rem", "n_rem", "remc"]
    i = names.index("h_grp_ptr")
    assert names[i:i + len(pair)] == pair and "bn_rcp" in names
    found = {name: tuple(_ctype(p) for p in params.split(","))
             for name, params in re.findall(
                 r'extern "C" int (\w+)\(([^)]*)\)', text)}
    assert found == tbuild.SIGNATURES["fused_layer"]


class _Recorder:
    """Stands in for the built library: keeps a copy of each struct and of
    the BN sd values it points to."""

    def __init__(self):
        self.params, self.sd = [], []

    def fused_layer(self, params, stream):
        p = tfl._Params.from_buffer_copy(params._obj)
        self.params.append(p)
        self.sd.append(None if p.sd is None else np.ctypeslib.as_array(
            (ctypes.c_float * p.f).from_address(p.sd)).copy())
        return 0


def test_launch_fills_pair_fields(monkeypatch):
    """What ``_launch`` hands the kernel for a pair launch: the halo's
    arrays and work items, rem with its row count and a scratch of its
    shape for the scaled rows, sd replaced by 1 / sd under ``bn_rcp``, and
    partial-sum scratch for the intra and the halo items."""
    import repro_torch.kernels.build as build
    import torch as torch_mod
    rng = np.random.default_rng(35)
    _, (ta, th) = _pair(rng)
    rec = _Recorder()
    sizes = {}
    real_empty = torch_mod.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        sizes[t.data_ptr()] = t.numel()
        return t
    monkeypatch.setattr(build, "library", lambda name: rec)
    monkeypatch.setattr(torch_mod.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    real_like = torch_mod.empty_like

    def empty_like(t, **kw):
        out = real_like(t, **kw)
        sizes[out.data_ptr()] = out.numel()
        return out
    monkeypatch.setattr(torch_mod, "empty", empty)
    monkeypatch.setattr(torch_mod, "empty_like", empty_like)
    w = tbin.BinTensor(torch.zeros((16, 2), dtype=torch.int32),
                       torch.ones((16, 1)), 40)
    x = torch.zeros((PAD_ROWS, 40))
    bn = (torch.zeros((1, 40)), torch.full((1, 40), 4.0))
    rem = torch.zeros((PAD_HALO, 16))
    tfl._launch(x, bn, w, ta, halo=th, rem=rem, bn_rcp=True)
    p = rec.params[-1]
    assert p.aggregate == 1 and p.bn_rcp == 1 and p.n_rem == PAD_HALO
    assert p.h_grp_ptr == th.grp_ptr.data_ptr()
    assert p.h_tiles == th.tiles.data_ptr()
    assert p.h_col_idx == th.col_idx.data_ptr()
    assert p.h_col_scale == th.col_scale.data_ptr()
    assert p.rem == rem.data_ptr() and sizes[p.remc] == rem.numel()
    assert p.h_item_ptr is not None
    items = tbk.max_items(ta) + tbk.max_items(th)
    assert sizes[p.part] == items * 4 * 16
    # the struct's sd is the reciprocal the plain version takes
    assert np.all(rec.sd[-1] == np.float32(0.25))
    # packed rem: no scratch, the walk reads it as it is
    remw = torch.zeros((PAD_HALO, 1), dtype=torch.int32)
    tfl._launch(x, bn, w, ta._replace(row_scale=None, col_scale=None),
                fbb=True, halo=th._replace(row_scale=None, col_scale=None),
                rem=remw)
    p = rec.params[-1]
    assert p.fbb == 1 and p.remc is None and p.rem == remw.data_ptr()
    assert p.bn_rcp == 0 and np.all(rec.sd[-1] == np.float32(4.0))


def test_launch_refuses_bad_pairs():
    rng = np.random.default_rng(36)
    _, (ta, th) = _pair(rng)
    w = tbin.BinTensor(torch.zeros((16, 2), dtype=torch.int32),
                       torch.ones((16, 1)), 40)
    x = torch.zeros((PAD_ROWS, 40))
    with pytest.raises(ValueError, match="rem"):
        tfl._launch(x, None, w, ta, halo=th)               # no rows
    with pytest.raises(ValueError, match="halo"):
        tfl._launch(x, None, w, ta, halo=th,
                    rem=torch.zeros((PAD_HALO, 8)))        # wrong width
    with pytest.raises(ValueError, match="halo"):
        tfl._launch(x, None, w, ta, halo=th,
                    rem=torch.zeros((PAD_HALO - 4, 16)))   # too few rows
