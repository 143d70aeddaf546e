"""Device dispatch of repro_torch.kernels.ops, the CUDA wrappers' input
checks, the kernel build paths, and the CUDA BSpMM work-item schedule, all
on the CPU."""
import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

import jax  # noqa: E402

from repro.core import bitops as jb, frdc as jf  # noqa: E402
tf = lazy("repro_torch.core.frdc")
tbk = lazy("repro_torch.kernels.bmm_kernel")
tsk = lazy("repro_torch.kernels.bspmm_kernel")
tfl = lazy("repro_torch.kernels.fused_layer")
tpk = lazy("repro_torch.kernels.pack_kernel")
build = lazy("repro_torch.kernels.build")
ops = lazy("repro_torch.kernels.ops")

jax.config.update("jax_platform_name", "cpu")


def _t(u32) -> "torch.Tensor":
    return torch.from_numpy(np.array(u32, np.uint32).view(np.int32))


def _packed(rng, rows, nbits):
    return np.asarray(jb.pack_bits(rng.integers(0, 2, (rows, nbits))))


def _graph(rng, n, density):
    return (rng.random((n, n)) < density).astype(np.float32)


def test_ops_dispatch_cpu_applies_scales_and_crops():
    """ops.bspmm_fp folds the column scale in before and applies the row
    scale after the raw kernel, cropped to n_rows (reference
    ops._serve_fp_backend)."""
    rng = np.random.default_rng(5)
    r, c = np.nonzero(rng.random((22, 22)) < 0.2)
    adj_j = jf.gcn_normalized(r, c, 22)
    adj_t = tf.gcn_normalized(r, c, 22, device="cpu")
    x = rng.standard_normal((22, 9)).astype(np.float32)
    want = np.asarray(jf.to_dense(adj_j)) @ x
    got = ops.bspmm_fp(adj_t, torch.from_numpy(x))
    assert got.shape == (22, 9)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    xp = _packed(rng, 22, 40)
    counts = ops.bspmm_bits(adj_t, _t(xp), 40, binarize=False)
    assert counts.shape == (22, 64)
    np.testing.assert_array_equal(
        ops.bspmm_bits(adj_t, _t(xp), 40).numpy(),
        tsk.bspmm_bits_plain(adj_t, _t(xp), 40)[:22].numpy())


def test_no_kernels_for_other_devices_and_cuda_wrappers_validate():
    """Dispatch raises for a device without kernels (no silent fallback),
    and the CUDA wrappers refuse CPU tensors instead of computing on them."""
    x = torch.zeros((4, 8), device="meta")
    with pytest.raises(RuntimeError, match="no kernels"):
        ops.binarize_pack(x)
    cpu = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        tpk.binarize_pack_cuda(cpu)
    with pytest.raises(ValueError):
        tbk.bmm_xnor_cuda(cpu.int(), cpu.int(), 8)
    adj = tf.from_coo([0], [1], 4, 4, device="cpu")
    with pytest.raises(ValueError):
        tsk.bspmm_fp_cuda(adj, cpu)
    with pytest.raises(ValueError):
        tsk.bspmm_bits_cuda(adj, cpu.int(), 8)
    before = ops.launch_counts()
    ops.binarize_pack(cpu)           # plain version: no launch counted
    assert ops.launch_counts() == before


def test_build_paths_and_missing_nvcc(monkeypatch):
    """Libraries are keyed on a hash of source and flags inside the ignored
    build directory; without nvcc the build fails loudly."""
    p = build.library_path("bspmm")
    assert p.parent == build.BUILD_DIR and p.name.startswith("bspmm-")
    assert p == build.library_path("bspmm")
    assert set(build.SIGNATURES) == set(build.SOURCES)
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


@pytest.mark.parametrize("hub_groups", [0, 1, 16, 17, 40])
def test_cuda_work_items_cover_every_group_once(hub_groups):
    """The fused layer's aggregation schedule: every tile-row owns at least
    one work item, its items cover its groups exactly, and the task list's
    heavy count (which sizes the scratch) is the heavy rows' items."""
    rng = np.random.default_rng(hub_groups)
    n = max(64, hub_groups * 32 + 8)
    a = _graph(rng, n, 0.01)
    a[n // 2:] = 0
    a[1, : hub_groups * 32] = 1.0     # tile-row 0 gets `hub_groups` groups
    adj = tf.pad_frdc(tf.from_dense(a, device="cpu"), n + 8,
                      n_groups=tf.from_dense(a, device="cpu").n_groups + 3)
    item_ptr, tasks = tsk.work_items(adj.grp_ptr), tfl.pair_items(adj)
    per = np.diff(adj.grp_ptr.numpy())
    items = np.diff(item_ptr.numpy())
    c = tsk.GROUPS_PER_ITEM
    np.testing.assert_array_equal(items, np.maximum(1, -(-per // c)))
    assert item_ptr[0] == 0 and tasks.n_part == int(items[items > 1].sum())
    assert tasks.tasks.shape[0] == tasks.n_part + int((items == 1).sum())
    assert all(k * c < max(p, 1) for p, k in zip(per, items - 1))
    assert item_ptr.dtype == torch.int32 and item_ptr.shape == (adj.n_tile_rows + 1,)
