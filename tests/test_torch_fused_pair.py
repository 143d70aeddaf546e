"""The sharded executors' fused step (the fused layer's transform, then
the intra+halo pair kernel) of the port against the reference's.

* The plain pair stages ``agg_fp_pair`` and ``agg_counts_pair`` against the
  reference's ``agg_fp_pair`` and ``agg_counts(intra) + agg_counts(halo)``
  run through ``fused_call`` (Pallas, interpret mode), on a rectangular
  (n_local_pad x n_halo_pad) halo adjacency with hub rows, with an empty
  halo and an empty shard: counts bit-exact, fp at 1e-5; the plain pair
  step (``pair_plain``, with its epilogue) on tile-rows of several work
  items in both matrices, and their task list (``pair_items``).
* Each family's layer steps in their fused form (``LayerStep.fused``, the
  plain versions here) against the reference's
  ``executor._fused_layer_compute`` of the same step in interpret mode, on
  inputs whose transform sums are exact in any order: packed words
  bit-exact, fp within 1e-5 of the sum of |terms|; and ``LayerStep.pair``
  of ``LayerStep.transform`` bit-equal to ``LayerStep.fused``.
* The C interface: ``_Params`` / ``_PairParams`` against ``Params`` in
  ``csrc/fused_layer.cu`` / ``csrc/fused_pair.cu`` and the exported
  functions against ``build.SIGNATURES``; what the wrappers put in the
  structs for the step's two launches (the transform with its self
  branch, the reciprocal of sd; the pair's halo arrays, tasks and
  scratch), with the library replaced by a recorder; and the pair
  arguments the wrapper refuses.
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
tbitops = lazy("repro_torch.core.bitops")
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


HUB_COLS, HUB_HALO = 600, 620     # a full row: 19 and 20 groups, 2 items


def _hub_pair(rng, scaled=True):
    """A shard whose tile-rows 0 (intra) and 1 (halo) hold a full row, two
    work items each, in both packages (unpadded): ((jax), (port))."""
    a = _coo(rng, ROWS, HUB_COLS, 0.03, hub=2)
    h = _coo(rng, ROWS, HUB_HALO, 0.03, hub=5)
    kw_a, kw_h = {}, {}
    if scaled:
        sr = rng.random(ROWS) + 0.5
        kw_a = dict(row_scale=sr, col_scale=rng.random(HUB_COLS) + 0.5)
        kw_h = dict(row_scale=sr, col_scale=rng.random(HUB_HALO) + 0.5)
    return ((jf.from_dense(a, **kw_a), jf.from_dense(h, **kw_h)),
            (tf.from_dense(a, device="cpu", **kw_a),
             tf.from_dense(h, device="cpu", **kw_h)))


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


def test_plain_pair_on_hub_rows():
    """The plain pair step on tile-rows of several work items in both
    matrices: fp rows through ``agg_fp_pair``, the self branch and the ReLU,
    and sign words of the two count sums, against the reference in
    interpret mode (fp at 1e-5, words bit-exact); ``pair`` on the CPU is
    that plain step; the task list puts every item of the two hub
    tile-rows first, in item order, then one task a light tile-row."""
    rng = np.random.default_rng(37)
    (ja, jh), (ta, th) = _hub_pair(rng)
    xl = rng.standard_normal((HUB_COLS, 24)).astype(np.float32)
    xr = rng.standard_normal((HUB_HALO, 24)).astype(np.float32)
    ys = rng.standard_normal((ROWS, 24)).astype(np.float32)

    def step(a, h, xa, xb, s):
        return jnp.maximum(s + jfl.agg_fp_pair(a, h, xa, xb), 0.0)
    want = _in_kernel(step, ja, jh, jnp.asarray(xl), jnp.asarray(xr),
                      jnp.asarray(ys))
    got = tfl.pair_plain(_t(xl), _t(ys), _t(xr), ta, th, relu=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(tfl.pair(_t(xl), _t(ys), _t(xr), ta, th, relu=True),
                       got)
    (ja, jh), (ta, th) = _hub_pair(rng, scaled=False)
    wl = np.asarray(jax.random.bits(jax.random.PRNGKey(3), (HUB_COLS, 2),
                                    jnp.uint32))
    wr = np.asarray(jax.random.bits(jax.random.PRNGKey(4), (HUB_HALO, 2),
                                    jnp.uint32))

    def counts(a, h, xa, xb):
        return jfl.agg_counts(a, xa) + jfl.agg_counts(h, xb)
    want = _in_kernel(counts, ja, jh, jnp.asarray(wl), jnp.asarray(wr))
    got = tfl.pair_plain(_t(wl.view(np.int32)), None, _t(wr.view(np.int32)),
                         ta, th, n_out=50)
    assert torch.equal(got, tbitops.pack_bits(_t(want[:, :50] >= 0),
                                              axis=-1))
    items = tfl.pair_items(ta, th)
    n_i = np.maximum(1, -(-np.diff(ta.grp_ptr.numpy()) // 16))
    n_h = np.maximum(1, -(-np.diff(th.grp_ptr.numpy()) // 16))
    assert n_i[0] == 2 and n_h[1] == 2 and (n_i[1:] == 1).all()
    heavy = [(r, k) for r in range(ta.n_tile_rows)
             if n_i[r] > 1 or n_h[r] > 1 for k in range(n_i[r] + n_h[r])]
    light = [(r, -1) for r in range(ta.n_tile_rows)
             if n_i[r] == 1 and n_h[r] == 1]
    assert items.n_part == len(heavy) == 6
    assert items.tasks.dtype == torch.int32
    assert items.tasks.tolist() == [list(t) for t in heavy + light]


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
        tbn = None if bn is None else tuple(map(_t, bn))
        got = ts.fused(tst, tbn, trem, ta, th, None).numpy()
        if ts.pair is not None:    # the two launches of the fused form
            y, ys = ts.transform(tst, tbn)
            assert ts.name == "fc" or (ys is not None) == (family in
                                                          ("sage", "saint"))
            np.testing.assert_array_equal(
                ts.pair(y, ys, trem, ta, th, tfl.pair_items(ta, th)).numpy(),
                got, err_msg=js.name)
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


def _struct_fields(source: str):
    text = (CSRC / source).read_text()
    body = re.search(r"struct Params \{(.*?)\n\};", text, re.S).group(1)
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if decl:
            fields.append((re.match(r".*?(\w+);$", decl).group(1),
                           _ctype(decl)))
    return text, fields


def test_params_and_signature_mirror_source():
    """``_Params`` and ``_PairParams`` have the fields of ``Params`` in
    ``csrc/fused_layer.cu`` and ``csrc/fused_pair.cu`` in order, the pair's
    fields only in the latter, and each source exports what
    ``build.SIGNATURES`` binds. The pair launch is an ordinary one: no
    cooperative launch, no grid barrier, no scaled copy of rem."""
    pair = ["h_grp_ptr", "h_tiles", "h_col_idx", "h_col_scale", "row_scale",
            "tasks", "row_done", "part", "y", "rem", "ys", "out"]
    for source, struct in (("fused_layer.cu", tfl._Params),
                           ("fused_pair.cu", tfl._PairParams)):
        text, fields = _struct_fields(source)
        assert fields == list(struct._fields_), source
        names = [n for n, _ in fields]
        found = {name: tuple(_ctype(p) for p in params.split(","))
                 for name, params in re.findall(
                     r'extern "C" int (\w+)\(([^)]*)\)', text)}
        assert found == tbuild.SIGNATURES[source[:-3]], source
        assert "remc" not in names and "kPair" not in text
        if source == "fused_layer.cu":
            assert "bn_rcp" in names and "h_grp_ptr" not in names
        else:
            i = names.index("h_grp_ptr")
            assert names[i:i + len(pair)] == pair
            assert "cudaLaunchCooperativeKernel" not in text
            assert "grid.sync" not in text and "this_grid" not in text


class _Recorder:
    """Stands in for the built libraries: keeps a copy of each struct, of
    the BN sd values it points to, and of the pair's task list."""

    def __init__(self):
        self.params, self.sd, self.tasks = [], [], []

    def fused_layer(self, params, stream):
        p = tfl._Params.from_buffer_copy(params._obj)
        self.params.append(p)
        self.sd.append(None if p.sd is None else np.ctypeslib.as_array(
            (ctypes.c_float * p.f).from_address(p.sd)).copy())
        return 0

    def fused_pair(self, params, stream):
        p = tfl._PairParams.from_buffer_copy(params._obj)
        self.params.append(p)
        self.tasks.append(np.ctypeslib.as_array(
            (ctypes.c_int32 * (2 * p.n_tasks)).from_address(p.tasks)).copy())
        return 0


def test_launch_fills_pair_fields(monkeypatch):
    """What the wrappers hand the kernels for the step's two launches: the
    transform with aggregate = 0, the self branch's weights and rows, and
    sd replaced by 1 / sd under ``bn_rcp``; the pair with both matrices'
    arrays and column scales, the shared row scale, the self branch, the
    task list of ``pair_items`` and scratch for its heavy rows' items only
    (no copy of rem), and words with their feature count."""
    import repro_torch.kernels.build as build
    import torch as torch_mod
    rng = np.random.default_rng(35)
    _, (ta, th) = _hub_pair(rng)
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
    monkeypatch.setattr(torch_mod, "empty", empty)
    w = tbin.BinTensor(torch.zeros((16, 2), dtype=torch.int32),
                       torch.ones((16, 1)), 40)
    x = torch.zeros((PAD_ROWS, 40))
    bn = (torch.zeros((1, 40)), torch.full((1, 40), 4.0))
    y, ys = tfl._launch(x, bn, w, None, w_s=w, bn_rcp=True, form="transform")
    p = rec.params[-1]
    assert p.aggregate == 0 and p.bn_rcp == 1 and p.out == y.data_ptr()
    assert p.ys == ys.data_ptr() and p.w_s == w.packed.data_ptr()
    assert tuple(y.shape) == tuple(ys.shape) == (PAD_ROWS, 16)
    # the struct's sd is the reciprocal the plain version takes
    assert np.all(rec.sd[-1] == np.float32(0.25))
    y, ys = torch.zeros((HUB_COLS, 16)), torch.zeros((ROWS, 16))
    rem = torch.zeros((HUB_HALO, 16))
    items = tfl.pair_items(ta, th)
    out = tfl._pair_launch(y, ys, rem, ta, th, items, True, None,
                           "s3_two_popc")
    p = rec.params[-1]
    assert (p.grp_ptr, p.tiles, p.col_idx, p.col_scale) == (
        ta.grp_ptr.data_ptr(), ta.tiles.data_ptr(), ta.col_idx.data_ptr(),
        ta.col_scale.data_ptr())
    assert (p.h_grp_ptr, p.h_tiles, p.h_col_idx, p.h_col_scale) == (
        th.grp_ptr.data_ptr(), th.tiles.data_ptr(), th.col_idx.data_ptr(),
        th.col_scale.data_ptr())
    assert p.row_scale == ta.row_scale.data_ptr()
    assert (p.y, p.rem, p.ys, p.out) == (y.data_ptr(), rem.data_ptr(),
                                         ys.data_ptr(), out.data_ptr())
    assert (p.n_y, p.n_rem, p.n_rows) == (HUB_COLS, HUB_HALO, ROWS)
    assert (p.ho, p.fbb, p.relu, p.n_tile_rows) == (16, 0, 1, ta.n_tile_rows)
    assert p.chunk == tbk.GROUPS_PER_ITEM
    assert (p.fp_sub, p.fp_cols) == (16, 1)
    assert np.array_equal(rec.tasks[-1], items.tasks.numpy().ravel())
    assert p.n_tasks == items.tasks.shape[0] and items.n_part > 0
    assert sizes[p.part] == items.n_part * 4 * 16
    assert sizes[p.row_done] == ta.n_tile_rows
    # words: the counts instance, no scales, no scratch without heavy rows
    remw = torch.zeros((HUB_HALO, 1), dtype=torch.int32)
    yw = torch.zeros((HUB_COLS, 1), dtype=torch.int32)
    a01 = ta._replace(row_scale=None, col_scale=None)
    h01 = th._replace(row_scale=None, col_scale=None)
    light = tfl.PairItems(torch.stack([torch.arange(ta.n_tile_rows),
                                       torch.full((ta.n_tile_rows,), -1)], 1)
                          .to(torch.int32), 0)
    tfl._pair_launch(yw, None, remw, a01, h01, light, False, 7,
                     "s2_and_andnot")
    p = rec.params[-1]
    assert (p.fbb, p.ho, p.s2) == (1, 7, 1)
    assert p.col_scale is None and p.h_col_scale is None and p.ys is None
    assert p.part is None and p.row_done is None and p.rem == remw.data_ptr()


def test_launch_refuses_bad_pairs():
    rng = np.random.default_rng(36)
    _, (ta, th) = _pair(rng)
    y = torch.zeros((PAD_ROWS, 16))
    args = (ta, th, None, False, None, "s3_two_popc")
    with pytest.raises(ValueError, match="rem"):
        tfl._pair_launch(y, None, torch.zeros((PAD_HALO, 8)), *args)
    with pytest.raises(ValueError, match="halo"):                # too few rows
        tfl._pair_launch(y, None, torch.zeros((PAD_HALO - 4, 16)), *args)
    with pytest.raises(ValueError, match="rem"):                 # dtypes
        tfl._pair_launch(y, None, torch.zeros((PAD_HALO, 16),
                                              dtype=torch.int32), *args)
    with pytest.raises(ValueError, match="halo"):                # its rows
        tfl._pair_launch(y, None, torch.zeros((PAD_HALO, 16)), ta,
                         th._replace(n_rows=PAD_ROWS - 4), *args[2:])
    with pytest.raises(ValueError, match="self branch"):
        tfl._pair_launch(y, torch.zeros((PAD_ROWS, 8)),
                         torch.zeros((PAD_HALO, 16)), *args)
    yw = torch.zeros((PAD_ROWS, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="output features"):     # no n_out
        tfl._pair_launch(yw, None, torch.zeros((PAD_HALO, 1),
                                               dtype=torch.int32), *args)
