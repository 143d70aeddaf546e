"""Card-only tests of the training path (``repro_torch.models.gnn``
training forwards, ``train_node_classifier``, ``frdc.to_sparse``).

They need a CUDA device and skip elsewhere. No JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_train.py

* the backward of a sparse product on the card (``sparse_adjacency``, and
  a bare CSR tensor), with respect to the dense operand, is finite and
  equal to the dense product's within rtol = atol = 1e-5, for the
  symmetric GCN adjacency and the row-scaled mean adjacency (whose
  transpose differs from it);
* one STE training step on the card (GCN Bi-GCN and GCN "bin", sparse
  adjacencies, fp32 products with TF32 off) equals the same step on the
  CPU: loss within 1e-5, parameters within rtol = atol = 1e-5 except at
  most 0.1% of entries, which stay within 2 * lr (Adam's first step scales
  each gradient to about +-1, so an entry whose gradient is near 0 carries
  the two devices' rounding difference into a step of up to lr);
* the training loop reads nothing back from the card per epoch: with
  ``torch.cuda.set_sync_debug_mode("error")`` the first synchronizing call
  comes after the sixth of 6 forwards;
* ``bspmm_kernel.bspmm_fp_walk_plain`` on the CPU is bit-equal to the 1D
  ``bspmm_fp`` kernel on the same float32 inputs, at widths of each lane
  layout, on a graph with hub tile-rows of 17, 40 and 300 groups and on
  its ``pad_frdc`` bucket (phase 13 of ``chip_smoke.py`` holds the card's
  trained forwards to CPU forwards that aggregate with it).
"""
import traceback

import numpy as np
import pytest

from torch_lazy import lazy, require_torch

require_torch()
torch = lazy("torch")

gnn = lazy("repro_torch.models.gnn")
frdc = lazy("repro_torch.core.frdc")
datasets = lazy("repro_torch.graphs.datasets")
bspmm_kernel = lazy("repro_torch.kernels.bspmm_kernel")

HIDDEN = 32


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


@pytest.fixture
def cora():
    return datasets.make_dataset("cora", seed=0, scale=0.15)


def _inputs(d, kinds, device):
    return (torch.from_numpy(d.x).to(device),
            *[gnn.sparse_adjacency(d.adjacency(k, device)) for k in kinds])


@pytest.mark.gpu
def test_sparse_backward_on_card_matches_dense(cuda, cora):
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((cora.n_nodes, 16)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((cora.n_nodes, 16))
                         .astype(np.float32)).to(cuda)
    for kind in ("gcn", "mean"):
        m = cora.adjacency(kind, cuda)
        grads = []
        for a in (frdc.to_dense(m), gnn.sparse_adjacency(m),
                  frdc.to_sparse(m)):
            x = torch.from_numpy(x0).to(cuda).requires_grad_()
            g, = torch.autograd.grad(((a @ x) * w).sum(), x)
            grads.append(g)
        for g in grads[1:]:
            assert bool(torch.isfinite(g).all()), kind
            torch.testing.assert_close(g, grads[0], rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_ste_step_on_card_matches_cpu(cuda, cora):
    y = torch.from_numpy(cora.y).long()
    mask = torch.from_numpy(cora.train_mask)
    lr = 3e-2
    for name, kinds in (("gcn_forward_bigcn", ("gcn",)),
                        ("gcn_forward_ste_bin", ("binary", "gcn"))):
        out = []
        for dev in ("cpu", cuda):
            p0 = gnn.init_gcn(6, cora.x.shape[1], HIDDEN, cora.n_classes, dev)
            out.append(gnn.train_node_classifier(
                getattr(gnn, name), p0, _inputs(cora, kinds, dev),
                y.to(dev), mask.to(dev), epochs=1, lr=lr))
        (p_cpu, loss_cpu), (p_card, loss_card) = out
        assert loss_card == pytest.approx(loss_cpu, abs=1e-5), name
        for f, a, b in zip(p_cpu._fields, p_cpu, p_card):
            b = b.cpu()
            assert bool(torch.isfinite(b).all()), (name, f)
            off = (a - b).abs() > 1e-5 + 1e-5 * a.abs()
            assert float(off.float().mean()) <= 1e-3, (name, f, int(off.sum()))
            torch.testing.assert_close(b, a, rtol=0, atol=2 * lr)


@pytest.mark.gpu
def test_training_loop_has_no_sync_per_epoch(cuda, cora):
    """Under ``torch.cuda.set_sync_debug_mode("error")`` the first
    synchronizing call comes after the last epoch's forward: the loop reads
    nothing back until it returns the loss."""
    y = torch.from_numpy(cora.y).long().to(cuda)
    mask = torch.from_numpy(cora.train_mask).to(cuda)
    inputs = _inputs(cora, ("binary", "gcn"), cuda)
    p0 = gnn.init_gcn(0, cora.x.shape[1], HIDDEN, cora.n_classes, cuda)
    calls = []

    def forward(p, *args):
        calls.append(len(calls))
        return gnn.gcn_forward_ste_bin(p, *args)

    gnn.train_node_classifier(forward, p0, inputs, y, mask, epochs=3)
    torch.cuda.synchronize()
    calls.clear()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gnn.train_node_classifier(forward, p0, inputs, y, mask, epochs=6)
    except RuntimeError as e:
        where = traceback.format_exc(limit=-4)
        assert "synchroniz" in str(e), where
    else:
        raise AssertionError("the returned loss did not synchronize")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(calls) == 6, where


@pytest.mark.gpu
def test_fp_walk_mirror_bit_equal_to_kernel(cuda):
    rng = np.random.default_rng(13)
    n, hubs = 10003, {1: 17, 3: 40, 5: 300}
    src = rng.integers(0, n // 2, 5 * n)
    keep = ~np.isin(src // 4, list(hubs))
    rows, cols = [src[keep]], [rng.integers(0, n, 5 * n)[keep]]
    for tr, groups in hubs.items():
        tc = np.arange(8 * groups)               # one tile per tile-column
        rows.append(tr * 4 + tc % 4)
        cols.append(tc * 4 + (tc * 7) % 4)
        extra = rng.integers(0, tc.size, tc.size // 3)   # more bits a tile
        rows.append(tr * 4 + (tc[extra] + 1) % 4)
        cols.append(tc[extra] * 4 + rng.integers(0, 4, extra.size))
    adj = frdc.from_coo(np.concatenate(rows), np.concatenate(cols), n, n,
                        device="cpu")
    per = (adj.grp_ptr[1:] - adj.grp_ptr[:-1]).numpy()
    assert {tr: int(per[tr]) for tr in hubs} == hubs
    for m in (adj, frdc.pad_frdc(adj, n + 13, n_groups=adj.n_groups + 11)):
        on_card = m._replace(**{k: getattr(m, k).to(cuda) for k in (
            "tiles", "col_idx", "group_row", "group_first", "grp_ptr")})
        for f in (1, 7, 16, 17, 64, 100):
            x = torch.from_numpy(rng.standard_normal((m.n_cols, f))
                                 .astype(np.float32))
            got = bspmm_kernel.bspmm_fp_cuda(on_card, x.to(cuda)).cpu()
            want = bspmm_kernel.bspmm_fp_walk_plain(m, x)
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (m.n_rows, f)
