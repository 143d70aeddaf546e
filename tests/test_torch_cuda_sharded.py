"""Card-only tests of the sharded slice: the fused step, the fused layer's
transform (``csrc/fused_layer.cu``) and the intra+halo pair kernel
(``csrc/fused_pair.cu``), against its plain version on the same device and,
without a halo, bit for bit against the one-launch fused kind; and the
host executor's distributed pass on the card against the same pass on the
CPU.

They need a CUDA device and nvcc (the kernels build on first use) and skip
elsewhere. No JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_sharded.py

Each kind runs with a halo: a (rows x rows) intra and a rectangular (rows x
halo) halo adjacency, both padded, with hub rows of many groups, and the
exchanged rows ``rem``. On inputs whose transform sums are exact in any
order (integer features, BN by 1 or 2, +-1 weights with power-of-two
scales) the packed words are bit-exact; fp outputs hold within 1e-5 of
their sum of |terms| plus 1e-6 (fp32 aggregation order), also on N(0,1)
inputs. Two runs are bit-equal.
"""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

binarize = lazy("repro_torch.core.binarize")
bitops = lazy("repro_torch.core.bitops")
frdc = lazy("repro_torch.core.frdc")
fused_layer = lazy("repro_torch.kernels.fused_layer")
ops = lazy("repro_torch.kernels.ops")
datasets = lazy("repro_torch.graphs.datasets")
tgnn = lazy("repro_torch.models.gnn")
tserve = lazy("repro_torch.serve")

FP_TOL, FP_TOL_ABS = 1e-5, 1e-6
ROWS, HALO = 3001, 1203          # neither a multiple of 4, 64 or 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _card(a, cuda):
    return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)


def _words(rng, rows, nbits, cuda):
    return bitops.pack_bits(torch.from_numpy(
        rng.integers(0, 2, (rows, nbits)))).to(cuda)


def _pair(rng, cuda, scaled, rows=ROWS, halo=HALO, intra_edges=True,
          halo_edges=True):
    """(intra, halo) FRDC matrices of one shard, padded as the executor
    pads them; hub rows of many groups in both."""
    def coo(n_cols, m, edges):
        if not edges:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        r, c = rng.integers(0, rows, m), rng.integers(0, n_cols, m)
        return (np.concatenate([r, np.full(n_cols, 5)]),
                np.concatenate([c, np.arange(n_cols)]))
    s_row = rng.uniform(0.2, 1.0, rows) if scaled else None
    s_halo = rng.uniform(0.2, 1.0, halo) if scaled else None
    a = frdc.from_coo(*coo(rows, 5 * rows, intra_edges), rows, rows,
                      row_scale=s_row, col_scale=s_row, device=cuda)
    h = frdc.from_coo(*coo(halo, 2 * rows, halo_edges), rows, halo,
                      row_scale=s_row, col_scale=s_halo, device=cuda)
    pad = frdc.align_tile(rows + 9)
    return (frdc.pad_frdc(a, pad, pad, n_groups=a.n_groups + 5),
            frdc.pad_frdc(h, pad, frdc.align_tile(halo),
                          n_groups=h.n_groups + 3))


def _weights(rng, n_out, n_in, cuda, normal=False):
    scale = rng.uniform(0.5, 1.5, (n_out, 1)) if normal \
        else rng.choice([0.25, 0.5, 1.0], (n_out, 1))
    return binarize.BinTensor(_words(rng, n_out, n_in, cuda),
                              _card(scale, cuda), n_in)


def _inputs(rng, rows, f, cuda, normal):
    if normal:
        x = rng.standard_normal((rows, f))
        bn = (0.1 * rng.standard_normal((1, f)), rng.uniform(0.5, 2.0, (1, f)))
    else:
        x = rng.integers(-3, 4, (rows, f))
        bn = (rng.integers(-1, 2, (1, f)), rng.choice([1.0, 2.0], (1, f)))
    return _card(x, cuda), (_card(bn[0], cuda), _card(bn[1], cuda))


def _hold(got, want, mag, what):
    err = (got - want).abs()
    assert bool((err <= FP_TOL * mag + FP_TOL_ABS).all()), \
        (what, float(err.max()))


def _kinds(rng, cuda, f, ho, normal):
    """(name, fused call, plain call, sum of |terms| or None for words)."""
    fl = fused_layer
    a, h = _pair(rng, cuda, scaled=True)
    a01, h01 = _pair(rng, cuda, scaled=False)
    n = a.n_rows
    x, bn = _inputs(rng, n, f, cuda, normal)
    w1, w2 = _weights(rng, ho, f, cuda, normal), _weights(rng, ho, f, cuda,
                                                         normal)
    hw = _words(rng, n, f, cuda)
    rem = _card(rng.standard_normal((h.n_cols, ho)) if normal
                else rng.integers(-3, 4, (h.n_cols, ho)), cuda)
    rem_w = _words(rng, h01.n_cols, ho, cuda)
    words, xs = fl._input(x, bn, True)
    y1, y2 = fl._bbf(words, xs, w1), fl._bbf(words, xs, w2)
    yw = fl._bbf(*fl._input(hw, None), w1)
    kw = dict(halo=h, rem=rem, bn_rcp=True)
    kinds = [
        ("gcn_bbf_fbf", lambda: fl.gcn_bbf_fbf(x, bn, w1, a, True, **kw),
         lambda: fl.gcn_bbf_fbf_plain(x, bn, w1, a, True, **kw),
         fl.agg_fp_pair(a, h, y1.abs(), rem.abs())),
        ("gcn_bbf_fbf/words",
         lambda: fl.gcn_bbf_fbf(hw, None, w1, a, halo=h, rem=rem),
         lambda: fl.gcn_bbf_fbf_plain(hw, None, w1, a, halo=h, rem=rem),
         fl.agg_fp_pair(a, h, yw.abs(), rem.abs())),
        ("branch_add/sum", lambda: fl.branch_add(x, bn, w1, w2, a01, True,
                                                 halo=h01, rem=rem[:h01.n_cols],
                                                 bn_rcp=True),
         lambda: fl.branch_add_plain(x, bn, w1, w2, a01, True, halo=h01,
                                     rem=rem[:h01.n_cols], bn_rcp=True),
         fl.agg_fp_pair(a01, h01, y2.abs(), rem[:h01.n_cols].abs())
         + y1.abs()),
        # no aggregation; the plain version sums the row's mean |z| in
        # another order, so fc is held to 1e-5 of |output|
        ("fc", lambda: fl.fc(x, bn, w1, bn_rcp=True),
         lambda: fl.fc_plain(x, bn, w1, bn_rcp=True), y1.abs()),
    ]
    if not normal:
        kinds.append(("gcn_bin_l1", lambda: fl.gcn_bin_l1(
            x, bn, w1, a01, halo=h01, rem=rem_w, bn_rcp=True),
            lambda: fl.gcn_bin_l1_plain(x, bn, w1, a01, halo=h01, rem=rem_w,
                                        bn_rcp=True), None))
    return kinds


@pytest.mark.gpu
@pytest.mark.parametrize("normal", [False, True], ids=["integer", "normal"])
def test_pair_kinds_match_plain(cuda, normal):
    """Every kind with a halo at f in {7, 500} and ho in {7, 64}: the
    transform and one pair launch each (fc: one launch), sign words
    bit-exact, fp within the tolerance, two runs bit-equal."""
    rng = np.random.default_rng(21 + normal)
    for f in (7, 500):
        for ho in (7, 64):
            for name, run, plain, mag in _kinds(rng, cuda, f, ho, normal):
                ops.reset_launch_counts()
                got, again = run(), run()
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                assert counts["fused_layer"] == 2, name   # transforms
                assert counts["fused_pair"] == (0 if name == "fc" else 2)
                assert torch.equal(got, again), (name, f, ho)
                if mag is None:
                    assert torch.equal(got, plain()), (name, f, ho)
                else:
                    _hold(got, plain(), mag, (name, f, ho))


def _pair_cases(rng, cuda, a, h, a01, h01):
    """(name, pair args, pair kwargs, sum of |terms| or None) of the pair
    kernel alone on transform-like rows: fp with and without the self
    branch and the ReLU at 7, 64 and 160 columns (sub-warp and whole-warp
    layouts), and sign words at 7, 64 and 160 features in both modes."""
    fl = fused_layer
    cases = []
    for ho in (7, 64, 160):
        y = _card(rng.standard_normal((a.n_cols, ho)), cuda)
        ys = _card(rng.standard_normal((a.n_rows, ho)), cuda)
        rem = _card(rng.standard_normal((h.n_cols, ho)), cuda)
        mag = fl.agg_fp_pair(a, h, y.abs(), rem.abs())
        cases.append((f"fp {ho}", (y, None, rem, a, h), {}, mag))
        cases.append((f"fp+self+relu {ho}", (y, ys, rem, a, h),
                      dict(relu=True), mag + ys.abs()))
        yw, remw = _words(rng, a01.n_cols, ho, cuda), \
            _words(rng, h01.n_cols, ho, cuda)
        for mode in ("s3_two_popc", "s2_and_andnot"):
            cases.append((f"words {ho} {mode}", (yw, None, remw, a01, h01),
                          dict(n_out=ho, trinary_mode=mode), None))
    return cases


@pytest.mark.gpu
def test_pair_kernel_matches_plain(cuda):
    """The pair kernel alone against ``pair_plain`` on the hub graph (row
    5's tile-row has several work items in both matrices), on a shard
    without halo edges and on a shard without any edge: sign words
    bit-exact, fp within 1e-5 of the sum of |terms| plus 1e-6, two runs
    bit-equal, one ``fused_pair`` launch a call and no other kernel."""
    rng = np.random.default_rng(26)
    fl = fused_layer
    graphs = {"hub": (_pair(rng, cuda, scaled=True),
                      _pair(rng, cuda, scaled=False))}
    for name, edges in (("empty halo", True), ("empty shard", False)):
        kw = dict(halo=1, intra_edges=edges, halo_edges=False)
        graphs[name] = (_pair(rng, cuda, True, **kw),
                        _pair(rng, cuda, False, **kw))
    for graph, ((a, h), (a01, h01)) in graphs.items():
        items, items01 = fl.pair_items(a, h), fl.pair_items(a01, h01)
        # row 5's intra edges make heavy rows wherever the shard has edges
        assert (items.n_part > 0) == (graph != "empty shard")
        for name, args, kw, mag in _pair_cases(rng, cuda, a, h, a01, h01):
            it = items01 if name.startswith("words") else items
            ops.reset_launch_counts()
            got, again = fl.pair(*args, it, **kw), fl.pair(*args, it, **kw)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            assert counts["fused_pair"] == 2 and sum(counts.values()) == 4, \
                counts        # fused_pair and its form
            assert torch.equal(got, again), (graph, name)
            want = fl.pair_plain(*args, **kw)
            if mag is None:
                assert torch.equal(got, want), (graph, name)
            else:
                _hold(got, want, mag, (graph, name))


@pytest.mark.gpu
def test_pair_step_equals_one_launch_without_halo(cuda):
    """Without halo edges the pair step (transform, then the pair kernel)
    adds +0.0 halo sums, so it is bit-equal to the one-launch fused kind on
    the intra matrix, whose items, sums and epilogue it keeps: GCN "full"
    (scaled, ReLU), SAGE's self + mean branch, GCN "bin" words 64 -> 7 and
    layer 1's sign words, BN by the reciprocal in both."""
    rng = np.random.default_rng(27)
    fl = fused_layer
    a, h = _pair(rng, cuda, scaled=True, halo=1, halo_edges=False)
    am, hm = a._replace(col_scale=None), h._replace(col_scale=None)
    a01, h01 = _pair(rng, cuda, scaled=False, halo=1, halo_edges=False)
    n = a.n_rows
    x, bn = _inputs(rng, n, 500, cuda, normal=True)
    w1, w2 = _weights(rng, 64, 500, cuda, True), _weights(rng, 64, 500, cuda,
                                                         True)
    w7, hw = _weights(rng, 7, 64, cuda, True), _words(rng, n, 64, cuda)
    rem = torch.zeros((h.n_cols, 64), device=cuda)
    cases = [
        ("gcn full", lambda: fl.gcn_bbf_fbf(x, bn, w1, a, True, halo=h,
                                            rem=rem, bn_rcp=True),
         lambda: fl.gcn_bbf_fbf(x, bn, w1, a, True, bn_rcp=True)),
        ("sage", lambda: fl.branch_add(x, bn, w1, w2, am, True, halo=hm,
                                       rem=rem, bn_rcp=True),
         lambda: fl.branch_add(x, bn, w1, w2, am, True, bn_rcp=True)),
        ("gcn bin layer 2", lambda: fl.gcn_bbf_fbf(hw, None, w7, a, halo=h,
                                                   rem=rem[:, :7]),
         lambda: fl.gcn_bbf_fbf(hw, None, w7, a)),
        ("gcn bin layer 1", lambda: fl.gcn_bin_l1(
            x, bn, w1, a01, halo=h01, rem=_words(rng, h01.n_cols, 64, cuda),
            bn_rcp=True),
         lambda: fl.gcn_bin_l1(x, bn, w1, a01, bn_rcp=True)),
    ]
    for name, step, one in cases:
        assert torch.equal(step(), one()), name


@pytest.mark.gpu
def test_pair_counts_add_exactly(cuda):
    """gcn_bin_l1's pair sums the intra and halo counts as integers: its
    words equal the signs of agg_counts(intra) + agg_counts(halo) over the
    kernel's own transform, in both trinary modes and at widths of one and
    of several words a pass."""
    rng = np.random.default_rng(23)
    a, h = _pair(rng, cuda, scaled=False)
    x, bn = _inputs(rng, a.n_rows, 96, cuda, normal=True)
    for ho in (7, 64, 160):
        w = _weights(rng, ho, 96, cuda, normal=True)
        hb = fused_layer.transform(x, bn, w, fbb=True, bn_rcp=True)
        rem = _words(rng, h.n_cols, ho, cuda)
        for mode in ("s3_two_popc", "s2_and_andnot"):
            got = fused_layer.gcn_bin_l1(x, bn, w, a, mode, halo=h, rem=rem,
                                         bn_rcp=True)
            counts = fused_layer.agg_counts_pair(a, h, hb, rem, mode)
            want = bitops.pack_bits(counts[:, :ho] >= 0, axis=-1)
            assert torch.equal(got, want), (ho, mode)


@pytest.mark.gpu
def test_reciprocal_bn_flag(cuda):
    """With one feature a row, the BBF transform's output is +-|z| times a
    power of two, exactly: the kernel takes BN as (x - mu) * (1 / sd) with
    the flag and as (x - mu) / sd without it, bit for bit as the plain
    version, and the two forms differ on some rows (sd = 3)."""
    rng = np.random.default_rng(24)
    x = _card(rng.standard_normal((4001, 1)), cuda)
    bn = (_card([[0.1]], cuda), _card([[3.0]], cuda))
    w = _weights(rng, 8, 1, cuda)
    rcp = fused_layer.transform(x, bn, w, bn_rcp=True)
    div = fused_layer.transform(x, bn, w)
    assert torch.equal(rcp, fused_layer.transform_plain(x, bn, w,
                                                        bn_rcp=True))
    assert torch.equal(div, fused_layer.fc_plain(x, bn, w))
    assert not torch.equal(rcp, div)
    # BMM.FBB through the flag: integer inputs, exact sums
    xi, bni = _inputs(rng, 1001, 70, cuda, normal=False)
    wi = _weights(rng, 40, 70, cuda)
    assert torch.equal(fused_layer.transform(xi, bni, wi, fbb=True,
                                             bn_rcp=True),
                       fused_layer.transform_plain(xi, bni, wi, fbb=True,
                                                   bn_rcp=True))


@pytest.mark.gpu
def test_empty_halo_and_empty_shard(cuda):
    """A shard without halo edges (one zero group) and an empty shard (no
    edge at all, as an edge-balanced cut can leave one): equal to the plain
    version, the empty one's rows to the self branch alone."""
    rng = np.random.default_rng(25)
    fl = fused_layer
    for rows, intra_edges in ((ROWS, True), (1, False)):
        a, h = _pair(rng, cuda, scaled=True, rows=rows, halo=1,
                     intra_edges=intra_edges, halo_edges=False)
        n = a.n_rows
        x, bn = _inputs(rng, n, 64, cuda, normal=False)
        w1, w2 = _weights(rng, 16, 64, cuda), _weights(rng, 16, 64, cuda)
        rem = torch.zeros((h.n_cols, 16), device=cuda)
        got = fl.branch_add(x, bn, w1, w2, a, halo=h, rem=rem, bn_rcp=True)
        words, xs = fl._input(x, bn, True)
        mag = fl.agg_fp(a, fl._bbf(words, xs, w2).abs()) \
            + fl._bbf(words, xs, w1).abs()
        _hold(got, fl.branch_add_plain(x, bn, w1, w2, a, halo=h, rem=rem,
                                       bn_rcp=True), mag, rows)
        remw = torch.zeros((h.n_cols, 1), dtype=torch.int32, device=cuda)
        a01 = a._replace(row_scale=None, col_scale=None)
        h01 = h._replace(row_scale=None, col_scale=None)
        got = fl.gcn_bin_l1(x, bn, w1, a01, halo=h01, rem=remw, bn_rcp=True)
        assert torch.equal(got, fl.gcn_bin_l1_plain(
            x, bn, w1, a01, halo=h01, rem=remw, bn_rcp=True)), rows


def _same_predictions(got, want, tol):
    """Equal predictions up to ties within the logit tolerance: each row's
    chosen class is a maximum of the other's logits within 2 tol (the
    fp32 sums of the two devices differ in order)."""
    rows = np.arange(got.shape[0])
    picked = want[rows, got.argmax(1)]
    assert bool((picked >= want.max(1) - 2 * tol * (1 + np.abs(picked)))
                .all()), int((got.argmax(1) != want.argmax(1)).sum())


def _same_bucket(*sessions):
    """Every serve core at the node cap: the fp32 GEMM of BMM.FBB may sum in
    another order at another padded row count on the card."""
    for sess in sessions:
        for core in getattr(sess, "cores", None) or [sess.core]:
            core.preset_water(core.node_cap, {}, 1.0)


def _store(family, data, device, fused):
    params = getattr(tgnn, f"init_{family}")(0, data.x.shape[1], 16,
                                             data.n_classes, device)
    st = tserve.GraphStore(max_batch=8, use_pallas=True, fused=fused,
                           device=device)
    st.register_graph("g", data)
    st.register_model("m", family, params)
    return st


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["gcn", "sage", "saint"])
def test_sharded_pass_and_routed_serve_on_card(cuda, family):
    """The host executor's distributed pass at P = 2 and 4 on the card,
    fused and unfused, against the same pass on the CPU under the card's
    frozen BN (logits within 1e-4, predictions equal up to ties within
    it), with the fused pass launching only the fused layer and pair
    kernels; routed
    serve_subgraph bit-exact
    against the single-host card session for the same per-owner batches."""
    data = datasets.make_dataset("cora", seed=0, scale=0.1)
    nodes = np.random.default_rng(3).integers(0, data.n_nodes, 8)
    for fused in (False, True):
        card = _store(family, data, cuda, fused)
        cpu = _store(family, data, "cpu", fused)
        single = card.session("g", "m")
        for p in (2, 4):
            sess = card.sharded_session("g", "m", p)
            twin = cpu.sharded_session("g", "m", p)
            twin.bn = tuple((m.cpu(), s.cpu()) for m, s in sess.bn)
            ops.reset_launch_counts()
            got = np.concatenate(sess.run_distributed_pass())
            counts = ops.launch_counts()
            want = np.concatenate(twin.run_distributed_pass())
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
            _same_predictions(got, want, 1e-4)
            if fused:
                assert counts["fused_layer"] > 0 and counts["fused_pair"] > 0 \
                    and not any(v for k, v in counts.items()
                                if not k.startswith("fused_")), counts
            _same_bucket(sess, single)
            owners = sess.routing.owner(nodes)
            served = sess.serve_subgraph(nodes)
            for o in np.unique(owners):
                sel = owners == o
                np.testing.assert_array_equal(
                    served[sel], single.serve_subgraph(nodes[sel]))
