"""Card-only tests of the tiled dense products (``csrc/xnor.cuh``):
``bmm_xnor`` (``bmm.cu``; its simt route at N <= 8, the mma route above),
the fused layer's transform phase (``fused_layer.cu``) and fc's own launch
over rows (``fused_fc`` in ``fused_layer.cu``), against their plain
PyTorch versions on the same device.

They need a CUDA device and nvcc (the kernels build on first use) and skip
elsewhere. No JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_xform.py

``bmm_xnor`` must be bit-exact at the tile edges: M in {1, 15, 16, 17,
89,250}, K in {7, 255, 256, 257, 500}, N in {1, 7, 8, 33, 64}, counts and
sign words, and past one K chunk or column tile. The fused kinds run at a
row count that is not a multiple of any tile: on integer inputs (sums exact
in any order) packed words are bit-exact and fp outputs within 1e-5 of
their sum of |terms| plus 1e-6 (fp32 aggregation order); on N(0,1) inputs
the fp outputs hold to the same tolerance, and the BMM.FBB signs equal
those of the fp64 product wherever |value| exceeds 1e-5 of its sum of
|terms|. Two runs are bit-equal. ``fused_fc`` equals its mirror
``fc_rows_plain`` bit for bit at f in {64, 65, 4096} and ho in {7, 41, 256},
with BN by the division and by the reciprocal, at row counts that are not
a multiple of a block's 32 rows. The aggregating kinds' task walk
(``csrc/tasks.cuh``) runs on a graph with hub tile-rows of 17 and 40
groups, empty tile-rows, and its ``pad_frdc`` bucket: each kind one launch,
bit-equal to the two-launch form (the transform alone, then the pair
kernel with an empty halo matrix) and to its plain version (words) or
within the tolerance (fp), with ReLU and both trinary formulas; a column
whose every gathered value is -0.0 stores +0.0.
"""
import ctypes

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

binarize = lazy("repro_torch.core.binarize")
bitops = lazy("repro_torch.core.bitops")
frdc = lazy("repro_torch.core.frdc")
bmm_kernel = lazy("repro_torch.kernels.bmm_kernel")
build = lazy("repro_torch.kernels.build")
fused_layer = lazy("repro_torch.kernels.fused_layer")
ops = lazy("repro_torch.kernels.ops")

FP_TOL, FP_TOL_ABS = 1e-5, 1e-6
EDGE_M = (1, 15, 16, 17, 89250)
EDGE_K = (7, 255, 256, 257, 500)
EDGE_N = (1, 7, 8, 33, 64)
ROWS = 3001                      # not a multiple of 4, 64 or 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _words(rng, rows, nbits, device):
    return bitops.pack_bits(torch.from_numpy(
        rng.integers(0, 2, (rows, nbits)))).to(device)


def _bmm_cases(cuda, shapes, modes=(False, True)):
    rng = np.random.default_rng(14)
    for m, n, k in shapes:
        a, b = _words(rng, m, k, cuda), _words(rng, n, k, cuda)
        for binz in modes:
            got = bmm_kernel.bmm_xnor_cuda(a, b, k, binz)
            assert torch.equal(got, bmm_kernel.bmm_xnor_plain(a, b, k, binz)), \
                (m, n, k, binz)


@pytest.mark.gpu
@pytest.mark.parametrize("binarize", [False, True], ids=["counts", "words"])
def test_bmm_xnor_tile_edges(cuda, binarize):
    _bmm_cases(cuda, [(m, n, k) for m in EDGE_M for n in EDGE_N
                      for k in EDGE_K], (binarize,))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_bmm_xnor_chunks_and_column_tiles(cuda):
    """K past one staged chunk (32 words), N past one column tile of either
    route, and A rows that are not 16-byte aligned (scalar staging)."""
    _bmm_cases(cuda, [(300, 65, 1025), (129, 300, 2000), (1000, 130, 64),
                      (700, 8, 1025), (513, 5, 2000)])
    rng = np.random.default_rng(1)
    buf = _words(rng, 257 * 16 + 1, 32, cuda).reshape(-1)
    assert buf[1:].data_ptr() % 16 == 4
    a = buf[1:].reshape(257, 16)                       # 4 bytes off
    for n in (7, 64):
        b = _words(rng, n, 512, cuda)
        for binz in (False, True):
            assert torch.equal(bmm_kernel.bmm_xnor_cuda(a, b, 512, binz),
                               bmm_kernel.bmm_xnor_plain(a, b, 512, binz))


@pytest.mark.gpu
def test_bmm_xnor_attributes_and_dispatch(cuda):
    """The kernel of each main-path width and of wide ones builds and fits
    the SM with its launch's dynamic shared memory; ops.bmm_xnor on a CUDA
    tensor launches the kernel once."""
    for n, wk in ((64, 16), (7, 2), (41, 2), (300, 63)):
        a = bmm_kernel.attributes(n, wk)
        assert 0 < a["dynamic_smem_bytes"] <= 227 * 1024, (n, wk, a)
        assert 0 < a["registers"] <= 255 and a["blocks_per_sm"] >= 1, a
    rng = np.random.default_rng(2)
    a, b = _words(rng, 100, 500, cuda), _words(rng, 64, 500, cuda)
    ops.reset_launch_counts()
    ops.bmm_xnor(a, b, 500)
    ops.bmm_xnor(a.cpu(), b.cpu(), 500)
    assert ops.launch_counts()["bmm_xnor"] == 1


def _graph(rng, cuda, gcn=True):
    src = rng.integers(0, ROWS, 6 * ROWS)
    dst = rng.integers(0, ROWS, 6 * ROWS)
    if gcn:
        return frdc.gcn_normalized(src, dst, ROWS, device=cuda)
    return frdc.from_coo(src, dst, ROWS, ROWS, device=cuda)


def _weights(rng, n_out, n_in, cuda, normal=False):
    scale = rng.uniform(0.5, 1.5, (n_out, 1)) if normal \
        else rng.choice([0.25, 0.5, 1.0], (n_out, 1))
    return binarize.BinTensor(_words(rng, n_out, n_in, cuda), torch.from_numpy(
        scale.astype(np.float32)).to(cuda), n_in)


def _inputs(rng, rows, f, cuda, normal):
    if normal:
        x = rng.standard_normal((rows, f))
        bn = (0.1 * rng.standard_normal((1, f)), rng.uniform(0.5, 2.0, (1, f)))
    else:
        x = rng.integers(-3, 4, (rows, f))
        bn = (rng.integers(-1, 2, (1, f)), rng.choice([1.0, 2.0], (1, f)))

    def card(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)
    return card(x), (card(bn[0]), card(bn[1]))


def _hold(got, want, mag):
    err = (got - want).abs()
    assert bool((err <= FP_TOL * mag + FP_TOL_ABS).all()), float(err.max())


def _fp_kinds(rng, cuda, f, ho, normal):
    """(name, fused call, plain call, sum of |terms|) of the fp kinds."""
    adj = _graph(rng, cuda)
    x, bn = _inputs(rng, ROWS, f, cuda, normal)
    w1, w2 = _weights(rng, ho, f, cuda, normal), _weights(rng, ho, f, cuda,
                                                         normal)
    h = _words(rng, ROWS, f, cuda)
    words, xs = fused_layer._input(x, bn)
    bbf1 = fused_layer._bbf(words, xs, w1).abs()
    bbf2 = fused_layer._bbf(words, xs, w2).abs()
    fl = fused_layer
    return [
        ("gcn_bbf_fbf", lambda: fl.gcn_bbf_fbf(x, bn, w1, adj, relu=True),
         lambda: fl.gcn_bbf_fbf_plain(x, bn, w1, adj, relu=True),
         fl.agg_fp(adj, bbf1)),
        ("gcn_bbf_fbf/words", lambda: fl.gcn_bbf_fbf(h, None, w1, adj),
         lambda: fl.gcn_bbf_fbf_plain(h, None, w1, adj),
         fl.agg_fp(adj, fl._bbf(*fl._input(h, None), w1).abs())),
        ("branch_add", lambda: fl.branch_add(x, bn, w1, w2, adj, relu=True),
         lambda: fl.branch_add_plain(x, bn, w1, w2, adj, relu=True),
         fl.agg_fp(adj, bbf2) + bbf1),
        # no aggregation: the plain version sums the row's mean |z| in
        # another order, so fc is held to 1e-5 of |output|
        ("fc", lambda: fl.fc(x, bn, w1), lambda: fl.fc_plain(x, bn, w1),
         bbf1),
    ]


@pytest.mark.gpu
@pytest.mark.parametrize("normal", [False, True], ids=["integer", "normal"])
def test_fused_bbf_kinds_match_plain(cuda, normal):
    """gcn_bbf_fbf (fp rows and packed words), branch_add and fc at f in
    {7, 500} and ho in {7, 64, 256}: one launch each, fp outputs within
    the tolerance, two runs bit-equal."""
    rng = np.random.default_rng(7 + normal)
    for f in (7, 500):
        for ho in (7, 64, 256):
            for name, run, plain, mag in _fp_kinds(rng, cuda, f, ho, normal):
                ops.reset_launch_counts()
                got, again = run(), run()
                torch.cuda.synchronize()
                assert ops.launch_counts()["fused_layer"] == 2, name
                assert torch.equal(got, again), (name, f, ho)
                _hold(got, plain(), mag)


@pytest.mark.gpu
def test_fused_gcn_bin_l1_exact_inputs(cuda):
    """BMM.FBB + BSpMM.BBB on integer inputs: sign words bit-exact against
    the plain version at f in {7, 500} and ho in {7, 64, 256}."""
    rng = np.random.default_rng(11)
    adj = _graph(rng, cuda, gcn=False)
    for f in (7, 500):
        x, bn = _inputs(rng, ROWS, f, cuda, normal=False)
        for ho in (7, 64, 256):
            w = _weights(rng, ho, f, cuda)
            got = fused_layer.gcn_bin_l1(x, bn, w, adj)
            assert torch.equal(got, fused_layer.gcn_bin_l1(x, bn, w, adj))
            assert torch.equal(got, fused_layer.gcn_bin_l1_plain(x, bn, w, adj)), \
                (f, ho)


@pytest.mark.gpu
def test_fused_gcn_bin_l1_normal_inputs(cuda):
    """On N(0,1) inputs, through the identity adjacency (each output bit is
    then the transform's own sign), the signs equal those of the fp64
    product wherever |value| > 1e-5 of its sum of |terms|."""
    rng = np.random.default_rng(12)
    eye = frdc.from_coo(np.arange(ROWS), np.arange(ROWS), ROWS, ROWS,
                        device=cuda)
    for f in (7, 500):
        x, bn = _inputs(rng, ROWS, f, cuda, normal=True)
        z = ((x - bn[0]) / bn[1]).double()
        for ho in (7, 64, 256):
            w = _weights(rng, ho, f, cuda, normal=True)
            w_eff = (bitops.unpack_pm1(w.packed, w.n) * w.scale).T.double()
            v, mag = z @ w_eff, z.abs() @ w_eff.abs()
            got = fused_layer.gcn_bin_l1(x, bn, w, eye)
            assert torch.equal(got, fused_layer.gcn_bin_l1(x, bn, w, eye))
            bits = bitops.unpack_bits(got, ho).bool()
            clear = v.abs() > FP_TOL * mag
            assert bool((bits == (v >= 0))[clear].all()), (f, ho)


@pytest.mark.gpu
def test_fused_largest_weights(cuda):
    """The widest layer the kernel takes (4,096 features to 256 outputs,
    two weights): the transform needs more than 48 KB of dynamic shared
    memory, the occupancy query sees it, and the cooperative launch runs."""
    rng = np.random.default_rng(13)
    f, ho = fused_layer.MAX_IN_WORDS * 32, fused_layer.MAX_OUT
    rows = 1001
    src, dst = rng.integers(0, rows, 4 * rows), rng.integers(0, rows, 4 * rows)
    adj = frdc.gcn_normalized(src, dst, rows, device=cuda)
    x, bn = _inputs(rng, rows, f, cuda, normal=False)
    w1, w2 = _weights(rng, ho, f, cuda), _weights(rng, ho, f, cuda)
    a = fused_layer.attributes(f, self_branch=True)
    assert a["dynamic_smem_bytes"] > 48 * 1024 and a["blocks_per_sm"] >= 1, a
    got = fused_layer.branch_add(x, bn, w1, w2, adj)
    words, xs = fused_layer._input(x, bn)
    mag = fused_layer.agg_fp(adj, fused_layer._bbf(words, xs, w2).abs()) \
        + fused_layer._bbf(words, xs, w1).abs()
    _hold(got, fused_layer.branch_add_plain(x, bn, w1, w2, adj), mag)
    assert fused_layer.attributes(f, fbb=True)["blocks_per_sm"] >= 1
    got = fused_layer.gcn_bin_l1(x, bn, w1, adj)
    assert torch.equal(got, fused_layer.gcn_bin_l1_plain(x, bn, w1, adj))


@pytest.mark.gpu
def test_fused_refused_launch_raises(cuda, monkeypatch):
    """A launch the card refuses (cudaErrorCooperativeLaunchTooLarge, 720,
    from the launcher) raises in the wrapper, which counts no launch and
    runs nothing else in its place; so does an fc launch, in both BN forms.
    fc's launcher itself refuses a width past the kernel's
    (cudaErrorInvalidValue, 1)."""
    rng = np.random.default_rng(15)
    rows = 1001
    src = rng.integers(0, rows, rows)
    adj = frdc.gcn_normalized(src, src, rows, device=cuda)
    x, bn = _inputs(rng, rows, 64, cuda, normal=False)
    w = _weights(rng, 7, 64, cuda)
    fused_layer.gcn_bbf_fbf(x, bn, w, adj)          # builds and loads
    fused_layer.fc(x, bn, w)
    wide = fused_layer._FcParams()
    wide.f, wide.wk, wide.ho, wide.n_in = 129 * 32, 129, 7, rows
    assert build.library("fused_layer").fused_fc(
        ctypes.byref(wide), torch.cuda.current_stream().cuda_stream) == 1

    class Refusing:
        def fused_layer(self, params, stream):
            return 720

        def fused_fc(self, params, stream):
            return 720
    monkeypatch.setitem(build._LIBS, "fused_layer", Refusing())
    before = dict(fused_layer.LAUNCHES)
    with pytest.raises(RuntimeError, match="fused_layer failed: cudaError 720"):
        fused_layer.gcn_bbf_fbf(x, bn, w, adj)
    for rcp in (False, True):
        with pytest.raises(RuntimeError,
                           match="fused_fc failed: cudaError 720"):
            fused_layer.fc(x, bn, w, bn_rcp=rcp)
    assert fused_layer.LAUNCHES == before


def _fc_cases(rng, cuda):
    """(f, ho, x, bn, w) at f in {64, 65, 4096} and ho in {7, 41, 256} on
    N(0,1) inputs, rows 3,001 (1,001 at 4,096 features)."""
    for f in (64, 65, 4096):
        rows = 1001 if f > 1000 else ROWS
        x, bn = _inputs(rng, rows, f, cuda, normal=True)
        for ho in (7, 41, 256):
            yield f, ho, x, bn, _weights(rng, ho, f, cuda, normal=True)


@pytest.mark.gpu
def test_fused_fc_bit_equal_to_mirror(cuda):
    """fc's own launch (``fused_fc``) in both BN forms: one launch a call
    (``fc+rcp`` counted for the reciprocal form), two runs bit-equal, and
    the output bit-equal to ``fc_rows_plain`` on the card; also on packed
    words and without BN, and at 33 and 1 rows."""
    rng = np.random.default_rng(16)
    for f, ho, x, bn, w in _fc_cases(rng, cuda):
        for rcp in (False, True):
            ops.reset_launch_counts()
            got, again = fused_layer.fc(x, bn, w, rcp), fused_layer.fc(
                x, bn, w, rcp)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["fused_layer"] == 2, (f, ho, rcp)
            assert counts["fused_layer/fc+rcp"] == (2 if rcp else 0)
            assert torch.equal(got, again), (f, ho, rcp)
            assert torch.equal(got, fused_layer.fc_rows_plain(x, bn, w, rcp)), \
                (f, ho, rcp)
    x, bn = _inputs(rng, 33, 65, cuda, normal=True)
    h = _words(rng, 33, 65, cuda)
    w = _weights(rng, 41, 65, cuda, normal=True)
    for args in ((x, None, w), (h, None, w), (x[:1], bn, w), (x, bn, w)):
        assert torch.equal(fused_layer.fc(*args),
                           fused_layer.fc_rows_plain(*args))
    for f in (64, 4096):
        a = fused_layer.fc_attributes(f)
        assert 0 < a["dynamic_smem_bytes"] <= 48 * 1024, (f, a)
        assert a["blocks_per_sm"] >= 1 and a["registers"] <= 255, a


HUB_GROUPS = {1: 17, 3: 40}     # tile-row: groups


def _hub_graph(rng, cuda, pad):
    """Random edges on the first half of the rows, tile-rows 1 and 3 of
    exactly HUB_GROUPS groups, empty tile-rows below; with ``pad`` the
    ``pad_frdc`` bucket (13 more rows, 11 more groups)."""
    src = rng.integers(0, ROWS // 2, 4 * ROWS)
    keep = ~np.isin(src // 4, list(HUB_GROUPS))
    rows, cols = [src[keep]], [rng.integers(0, ROWS, 4 * ROWS)[keep]]
    for tr, groups in HUB_GROUPS.items():
        tc = np.arange(8 * groups)               # one tile per tile-column
        rows.append(tr * 4 + tc % 4)
        cols.append(tc * 4 + (tc * 7) % 4)
    adj = frdc.from_coo(np.concatenate(rows), np.concatenate(cols), ROWS,
                        ROWS, device=cuda)
    per = (adj.grp_ptr[1:] - adj.grp_ptr[:-1]).cpu().numpy()
    assert {tr: int(per[tr]) for tr in HUB_GROUPS} == HUB_GROUPS
    if pad:
        adj = frdc.pad_frdc(adj, ROWS + 13, n_groups=adj.n_groups + 11)
    n = adj.n_cols
    scale = torch.from_numpy(rng.uniform(0.25, 1.0, n).astype(np.float32))
    return adj, adj._replace(row_scale=scale.to(cuda),
                             col_scale=scale.flip(0).contiguous().to(cuda))


def _empty_halo(adj):
    none = torch.zeros((0, 8), dtype=torch.int32, device=adj.device)
    return adj._replace(tiles=none, col_idx=none.clone(),
                        group_row=none[:, 0].contiguous(),
                        group_first=none[:, 0].contiguous(),
                        grp_ptr=torch.zeros_like(adj.grp_ptr), n_cols=0,
                        nnz=0, row_scale=None, col_scale=None)


@pytest.mark.gpu
def test_fused_task_walk_matches_plain(cuda):
    fl = fused_layer
    rng = np.random.default_rng(17)
    f, ho, n_cls = 500, 64, 7
    for pad in (False, True):
        adj01, scaled = _hub_graph(rng, cuda, pad)
        n = adj01.n_cols
        mean = scaled._replace(col_scale=None)
        x, bn = _inputs(rng, n, f, cuda, normal=True)
        # BMM.FBB on integers: its sums are exact in the plain order too
        xi, bni = _inputs(rng, n, f, cuda, normal=False)
        wi = _weights(rng, ho, f, cuda)
        h = _words(rng, n, ho, cuda)
        w1, w2 = (_weights(rng, ho, f, cuda, normal=True) for _ in range(2))
        w3 = _weights(rng, n_cls, ho, cuda, normal=True)
        rem = {torch.int32: torch.zeros((4, 2), dtype=torch.int32,
                                        device=cuda),
               torch.float32: torch.zeros((4, ho), device=cuda)}

        def two(y, ys, adj, **kw):
            halo = _empty_halo(adj)
            return fl.pair(y, ys, rem[y.dtype][:, :y.shape[1]].contiguous(),
                           adj, halo, fl.pair_items(adj, halo), **kw)
        cases = []
        for mode in ("s2_and_andnot", "s3_two_popc"):
            cases.append((f"gcn_bin_l1 {mode}",
                          lambda m=mode: fl.gcn_bin_l1(xi, bni, wi, adj01, m),
                          lambda m=mode: fl.gcn_bin_l1_plain(xi, bni, wi,
                                                             adj01, m),
                          lambda m=mode: two(fl.transform(xi, bni, wi,
                                                          fbb=True),
                                             None, adj01, n_out=ho,
                                             trinary_mode=m), None))
        for relu in (False, True):
            words, xs = fl._input(h, None)
            cases.append((f"gcn_bbf_fbf words relu={relu}",
                          lambda r=relu: fl.gcn_bbf_fbf(h, None, w3, scaled, r),
                          lambda r=relu: fl.gcn_bbf_fbf_plain(h, None, w3, scaled, r),
                          lambda r=relu: two(fl.transform(h, None, w3), None,
                                             scaled, relu=r),
                          fl.agg_fp(scaled, fl._bbf(words, xs, w3).abs())))
            words, xs = fl._input(x, bn)
            cases.append((f"branch_add relu={relu}",
                          lambda r=relu: fl.branch_add(x, bn, w1, w2, mean, r),
                          lambda r=relu: fl.branch_add_plain(x, bn, w1, w2, mean, r),
                          lambda r=relu: two(*fl.transform(x, bn, w2, w_self=w1),
                                             mean, relu=r),
                          fl.agg_fp(mean, fl._bbf(words, xs, w2).abs())
                          + fl._bbf(words, xs, w1).abs()))
        tasks = fl.pair_items(adj01)
        assert tasks.n_part == sum(-(-g // 16) for g in HUB_GROUPS.values())
        for name, one, plain, pair2, mag in cases:
            ops.reset_launch_counts()
            got, again = one(), one()
            torch.cuda.synchronize()
            assert ops.launch_counts()["fused_layer"] == 2, name
            assert torch.equal(got, again), (name, pad)
            assert torch.equal(got.view(torch.int32),
                               pair2().view(torch.int32)), (name, pad)
            if mag is None:
                assert torch.equal(got, plain()), (name, pad)
            else:
                _hold(got, plain(), mag)
        # every gathered value of column 0 is -0.0 (a zero count times a
        # negative weight scale): the stored sums are +0.0
        zero = torch.zeros((n, 2), dtype=torch.int32, device=cuda)
        w0 = _weights(rng, n_cls, ho, cuda, normal=True)
        w0.packed[0] = torch.tensor([-1, 0], dtype=torch.int32)
        w0.scale[0] = -w0.scale[0]
        for relu in (False, True):
            out = fl.gcn_bbf_fbf(zero, None, w0, scaled, relu)
            assert bool((out[:, 0].view(torch.int32) == 0).all()), (pad, relu)
