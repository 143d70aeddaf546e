"""Host side of the aggregating fused kernels' task walk
(``csrc/tasks.cuh``) and of the 1D fp kernel's summation order, on the CPU.

* The single-host kinds' task list (``fused_layer.pair_items`` of one
  matrix): every item of every tile-row once, the heavy rows' items first
  and in order, light rows as ``(row, -1)``; with an empty halo matrix the
  pair list differs only by each heavy row's one empty halo item. On a
  seeded graph with hub tile-rows of 17 and 40 groups, empty tile-rows,
  and its ``pad_frdc`` copy.
* The C interface: ``_Params`` against ``Params`` in
  ``csrc/fused_layer.cu``, one grid barrier and no binary search there,
  both kernels on the shared header; what ``_launch`` puts in the struct
  (the task list, its heavy count, scratch for the heavy items only) with
  the library replaced by a recorder; malformed lists refused; on a CPU
  tensor the entry points run their plain versions and the launch path
  raises before a library is built.
* ``bspmm_kernel.bspmm_fp_walk_plain``, the CPU mirror of the card's fp
  order: equal bit for bit to a loop that follows the kernel's code step by
  step (light rows, chunk items, batches of 4 groups, hits in group and
  bit order, sub-warps, the fold), and within 1e-5 of the sum of |terms|
  of ``bspmm_fp_plain`` and of the reference ``bspmm_fp`` (Pallas in
  interpret mode) at F in {7, 64}.
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

from repro.kernels import bspmm_kernel as jk  # noqa: E402
from test_torch_fp_walk import HUBS, N, _pair  # noqa: E402
tbin = lazy("repro_torch.core.binarize")
tbitops = lazy("repro_torch.core.bitops")
tk = lazy("repro_torch.kernels.bspmm_kernel")
tfl = lazy("repro_torch.kernels.fused_layer")

jax.config.update("jax_platform_name", "cpu")

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
FP_TOL = 1e-5


def _items(adj):
    per = np.diff(adj.grp_ptr.numpy())
    return np.maximum(1, -(-per // tk.GROUPS_PER_ITEM))


def _empty_halo(adj):
    none = torch.zeros((0, 8), dtype=torch.int32)
    return adj._replace(tiles=none, col_idx=none.clone(),
                        group_row=torch.zeros(0, dtype=torch.int32),
                        group_first=torch.zeros(0, dtype=torch.int32),
                        grp_ptr=torch.zeros_like(adj.grp_ptr), n_cols=0,
                        nnz=0, row_scale=None, col_scale=None)


@pytest.mark.parametrize("pad", [False, True])
def test_one_matrix_tasks_cover_every_item_once(pad):
    ta, _ = _pair(3, pad)
    items = _items(ta)
    got = tfl.pair_items(ta)
    tasks = got.tasks.numpy()
    assert got.tasks.dtype == torch.int32 and tasks.shape[1] == 2
    heavy = [r for r in range(ta.n_tile_rows) if items[r] > 1]
    assert heavy == sorted(tr for tr, g in HUBS.items() if g > 16)
    want_heavy = [(r, k) for r in heavy for k in range(items[r])]
    assert got.n_part == len(want_heavy) == items[heavy].sum()
    assert [tuple(t) for t in tasks[:got.n_part]] == want_heavy
    light = tasks[got.n_part:]
    assert (light[:, 1] == -1).all()
    assert light[:, 0].tolist() == [r for r in range(ta.n_tile_rows)
                                    if items[r] == 1]
    # empty tile-rows are light tasks too (they store 0 / sign(0) words)
    assert int((np.diff(ta.grp_ptr.numpy()) == 0).sum()) > 0


def test_one_matrix_tasks_are_pair_items_with_an_empty_halo():
    ta, _ = _pair(4, pad=True)
    one, two = tfl.pair_items(ta), tfl.pair_items(ta, _empty_halo(ta))
    items = _items(ta)
    pair = two.tasks.numpy()
    # drop each heavy row's empty halo item (k == n_intra)
    keep = np.array([k < items[r] for r, k in pair])
    assert np.array_equal(pair[keep], one.tasks.numpy())
    assert two.n_part == one.n_part + int((items > 1).sum())
    with pytest.raises(ValueError, match="tile-rows"):
        tfl.pair_items(ta, _empty_halo(ta)._replace(n_rows=ta.n_rows + 8))


def _struct_fields(text):
    body = re.search(r"struct Params \{(.*?)\n\};", text, re.S).group(1)
    names = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip()
        if decl:
            names.append(re.match(r".*?(\w+);$", decl).group(1))
    return names


def test_params_and_sources_take_the_task_walk():
    """``_Params`` has ``Params``' fields in order, with the task list in
    place of item_ptr; the cooperative kernel has one grid barrier and no
    binary search; both aggregating kernels include the shared walk."""
    layer = (CSRC / "fused_layer.cu").read_text()
    names = _struct_fields(layer)
    assert names == [n for n, _ in tfl._Params._fields_]
    assert "item_ptr" not in layer and "find_item" not in layer
    assert names[names.index("chunk") + 1:][:4] == ["tasks", "row_done",
                                                    "n_tasks", "n_part"]
    assert layer.count("grid.sync()") == 1
    assert "cudaLaunchCooperativeKernel" in layer
    for source in ("fused_layer.cu", "fused_pair.cu"):
        assert '#include "tasks.cuh"' in (CSRC / source).read_text()
    walk = (CSRC / "tasks.cuh").read_text()
    assert "grid.sync" not in walk and "last_arrival" in walk


class _Recorder:
    def __init__(self):
        self.params, self.tasks = [], []

    def fused_layer(self, params, stream):
        p = tfl._Params.from_buffer_copy(params._obj)
        self.params.append(p)
        self.tasks.append(None if not p.n_tasks else np.ctypeslib.as_array(
            (ctypes.c_int32 * (2 * p.n_tasks)).from_address(p.tasks)).copy())
        return 0


def test_launch_fills_task_fields(monkeypatch):
    """What ``_launch`` hands the cooperative kernel: the task list given
    (or ``pair_items(adj)`` when none is), its length and heavy count,
    tickets for every tile-row and scratch for the heavy items only; none
    of either for a list without heavy rows. A malformed list raises."""
    import repro_torch.kernels.build as build
    import torch as torch_mod
    ta, _ = _pair(5, pad=True)
    rec, sizes = _Recorder(), {}
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
    x = torch.zeros((ta.n_cols, 40))
    want = tfl.pair_items(ta)
    for given in (want, None):
        out = tfl._launch(x, None, w, ta, relu=True, tasks=given)
        p = rec.params[-1]
        assert (p.aggregate, p.relu, p.chunk) == (1, 1, tk.GROUPS_PER_ITEM)
        assert np.array_equal(rec.tasks[-1], want.tasks.numpy().ravel())
        assert (p.n_tasks, p.n_part) == (want.tasks.shape[0], want.n_part)
        assert want.n_part > 0 and sizes[p.part] == want.n_part * 4 * 16
        assert sizes[p.row_done] == ta.n_tile_rows
        assert p.out == out.data_ptr() and p.n_tile_rows == ta.n_tile_rows
    light = tfl.PairItems(want.tasks[want.n_part:].contiguous(), 0)
    tfl._launch(x, None, w, ta, tasks=light)
    p = rec.params[-1]
    assert p.part is None and p.row_done is None and p.n_part == 0
    words = torch.zeros((ta.n_cols, 40))
    tfl._launch(words, None, w, ta, fbb=True, trinary_mode="s2_and_andnot",
                tasks=want)
    p = rec.params[-1]
    assert (p.fbb, p.s2) == (1, 1) and sizes[p.part] == want.n_part * 4 * 32
    for bad in (tfl.PairItems(want.tasks, want.tasks.shape[0] + 1),
                tfl.PairItems(want.tasks.reshape(-1), 0)):
        with pytest.raises(ValueError, match="task list"):
            tfl._launch(x, None, w, ta, tasks=bad)


def test_entry_points_take_tasks_and_keep_cpu_tensors_off_the_launch(
        monkeypatch):
    """On a CPU tensor each aggregating kind runs its plain version with or
    without a task list, with the same result; the launch path itself
    raises on a CPU tensor before any library is built."""
    rng = np.random.default_rng(6)
    ta, _ = _pair(6)
    f, ho = 40, 16
    tasks = tfl.pair_items(ta)

    def weights():
        return tbin.BinTensor(
            tbitops.pack_bits(torch.from_numpy(rng.integers(0, 2, (ho, f)))),
            torch.from_numpy(rng.uniform(0.5, 1.5, (ho, 1)).astype(
                np.float32)), f)
    w1, w2 = weights(), weights()
    x = torch.from_numpy(rng.standard_normal((N, f)).astype(np.float32))
    calls = (lambda **kw: tfl.gcn_bin_l1(x, None, w1, ta, **kw),
             lambda **kw: tfl.gcn_bbf_fbf(x, None, w1, ta, True, **kw),
             lambda **kw: tfl.branch_add(x, None, w1, w2, ta, True, **kw))
    for call in calls:
        assert torch.equal(call(tasks=tasks), call())

    import repro_torch.kernels.build as build

    def no_build(name):
        raise AssertionError(f"built {name} for a CPU tensor")
    monkeypatch.setattr(build, "library", no_build)
    with pytest.raises((RuntimeError, AssertionError, ValueError)) as err:
        tfl._launch(x, None, w1, ta, tasks=tasks)
    assert "built" not in str(err.value)


def _loop_order(adj, x):
    """The 1D fp kernel's code step by step, in float32: walks (a light
    tile-row, or a 16-group chunk item of a heavy one), batches of 4
    groups, hits in (group, lane) order, hit e to sub-warp e % subs, the
    fold tree; a heavy row's items added from 0 in chunk order."""
    x = x.numpy()
    f = x.shape[1]
    subs = 32 // tk.fp_layout(f, f, 0).sub
    gp, tiles, cols = (adj.grp_ptr.numpy(), adj.tiles.numpy(),
                       adj.col_idx.numpy())

    def walk(g0, g1):
        acc = np.zeros((subs, 4, f), np.float32)
        for gb in range(g0, g1, 4):
            hits = [(int(cols[g, lane >> 2]) * 4 + (lane & 3),
                     [(int(tiles[g, lane >> 2]) >> (4 * i + (lane & 3))) & 1
                      for i in range(4)])
                    for g in range(gb, min(gb + 4, g1)) for lane in range(32)]
            hits = [(r, m) for r, m in hits if any(m) and r < x.shape[0]]
            for e, (r, m) in enumerate(hits):
                for i in range(4):
                    if m[i]:
                        acc[e % subs, i] = acc[e % subs, i] + x[r]
        d = subs // 2
        while d:
            acc = acc[:d] + acc[d:2 * d]
            d //= 2
        return acc[0]
    out = np.zeros((adj.n_tile_rows, 4, f), np.float32)
    for r in range(adj.n_tile_rows):
        g0, g1 = int(gp[r]), int(gp[r + 1])
        if g1 - g0 <= tk.GROUPS_PER_ITEM:
            out[r] = walk(g0, g1)
            continue
        for k in range(g0 // 16, (g1 - 1) // 16 + 1):
            out[r] = out[r] + walk(max(16 * k, g0), min(16 * k + 16, g1))
    return torch.from_numpy(out.reshape(-1, f))


def test_fp_walk_mirror_follows_the_kernel_step_by_step():
    for f, pad in ((7, False), (33, True)):
        ta, _ = _pair(f, pad)
        x = torch.from_numpy(10 * np.random.default_rng(f).standard_normal(
            (N, f)).astype(np.float32))
        got = tk.bspmm_fp_walk_plain(ta, x)
        assert torch.equal(got.view(torch.int32),
                           _loop_order(ta, x).view(torch.int32)), (f, pad)


@pytest.mark.parametrize("pad", [False, True], ids=["hub", "padded"])
@pytest.mark.parametrize("f", [7, 64])
def test_fp_walk_mirror_matches_plain_and_reference(f, pad):
    ta, ja = _pair(f, pad)
    x = np.random.default_rng(f).standard_normal((N, f)).astype(np.float32)
    xt = torch.from_numpy(x)
    got = tk.bspmm_fp_walk_plain(ta, xt)
    mag = tk.bspmm_fp_plain(ta, xt.abs())
    want = {"plain": tk.bspmm_fp_plain(ta, xt),
            "reference": torch.from_numpy(np.array(jk.bspmm_fp(
                ja, jnp.asarray(x))))}
    for name, ref in want.items():
        assert got.shape == ref.shape, name
        err = (got - ref).abs()
        assert bool((err <= FP_TOL * mag).all()), (name, float(err.max()))
    if pad:
        assert not bool(got[N:].any())
