"""FRDC BSpMM kernels: Algorithm 1 on packed ±1 activations, and its fp twin.

Replaces the Pallas TPU kernels ``repro/kernels/bspmm_kernel.py:bspmm_bits``
(``_bits_kernel``, 1D grid) and ``bspmm_kernel.py:bspmm_fp`` (``_fp_kernel``,
1D grid) with ``csrc/bspmm.cu``. The TPU kernels walk the flattened group
list on a sequential grid and keep the accumulator in VMEM across steps.
The CUDA kernels give one warp a work item of at most
``GROUPS_PER_ITEM`` consecutive groups of one tile-row (from ``grp_ptr``),
so a power-law hub row (1,399 groups on Flickr, mean 5) is spread over many
warps. A row with one item is stored straight from registers; the partial
sums of a row with several items are added in item order by the warp that
finishes the row last, so results do not depend on scheduling.

* ``bspmm_bits``: Steps ②-⑤ of the paper's warp algorithm — lane k gathers
  neighbour word k, the eight 4x4 tiles are OR-reduced into four adjacency
  words, 32 ``__ballot_sync`` calls transpose the 32x32 bit block (LSB-first,
  so no ``__brev``), and each lane accumulates the trinary popc (s3 or s2)
  of one feature for the four rows. Binarize mode stores sign words with
  the tail past ``n_feat`` masked.
* ``bspmm_fp``: lanes over 32 features; per group the warp starts the
  gathers of all set adjacency columns (coalesced slices of neighbour rows)
  before adding them to the rows that have the bit.

Both are bound by bytes on the H100 (gathered activation rows, group
arrays, output). Empty tile-rows store 0 (binarized: sign(0) = +1 bits with
the tail masked, the TPU prefill); ``pad_frdc`` bucket groups past
``grp_ptr[-1]`` are never visited; neighbour rows past the activation's row
count read as 0.
"""
from __future__ import annotations

import torch

from ..core import bitops
from ..core.frdc import FRDCMatrix, GROUP_COLS, TILE, coarsen_groups, \
    group_neighbor_ids
from . import build

WORD = 32
LAUNCHES = {"bspmm_bits": 0, "bspmm_fp": 0}  # CUDA launches (plain calls not counted)
# groups per chunk of the plain versions: bounds their gathered temporaries
_CHUNK_ELEMS = 1 << 24
TRINARY_MODES = ("s2_and_andnot", "s3_two_popc")
GROUPS_PER_ITEM = 16   # groups of one tile-row per CUDA warp


def _gather_rows(x: torch.Tensor, adj: FRDCMatrix) -> torch.Tensor:
    """x padded with zero rows so every gathered neighbour id is in range."""
    need = max(x.shape[0], -(-adj.n_cols // TILE) * TILE)
    pad = need - x.shape[0]
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def _chunks(adj: FRDCMatrix, per_group: int):
    step = max(1, _CHUNK_ELEMS // max(per_group, 1))
    for lo in range(0, adj.n_groups, step):
        yield slice(lo, min(lo + step, adj.n_groups))


def bspmm_bits_plain(adj: FRDCMatrix, x_packed: torch.Tensor, n_feat: int,
                     binarize: bool = True,
                     trinary_mode: str = "s3_two_popc") -> torch.Tensor:
    """Plain PyTorch version of Algorithm 1: gather 32 neighbour rows per
    group, bit-transpose, trinary popc against the coarsened adjacency
    words, ``index_add_`` per tile-row. Returns (R4, Wf*32) int32 counts or
    (R4, Wf) sign words (R4 = n_tile_rows*4)."""
    if trinary_mode not in TRINARY_MODES:
        raise ValueError(trinary_mode)
    wf = x_packed.shape[1]
    xp = _gather_rows(x_packed, adj)
    counts = torch.zeros((adj.n_tile_rows, TILE, wf * WORD), dtype=torch.int64,
                         device=x_packed.device)
    for sl in _chunks(adj, GROUP_COLS * wf * WORD):
        bg = xp[group_neighbor_ids(adj.col_idx[sl]).long()]      # (g, 32, Wf)
        bt = bitops.as_u32(bitops.bit_transpose_32(bg.transpose(-1, -2)))
        a = bitops.as_u32(coarsen_groups(adj.tiles[sl]))[:, :, None, None]
        b = bt[:, None, :, :]                                   # (g,1,Wf,32)
        if trinary_mode == "s3_two_popc":
            c = 2 * bitops.popcount(a & b) - bitops.popcount(a)
        else:
            c = bitops.popcount(a & b) - bitops.popcount(a & (b ^ bitops.MASK32))
        counts.index_add_(0, adj.group_row[sl].long(),
                          c.reshape(c.shape[0], TILE, wf * WORD))
    counts = counts.reshape(-1, wf * WORD).to(torch.int32)
    if not binarize:
        return counts
    return bitops.pack_bits(counts[:, :n_feat] >= 0, axis=-1)


def bspmm_fp_plain(adj: FRDCMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fp kernel: gather, (4, 32) mask times
    (32, F) rows per group, ``index_add_`` per tile-row. Raw (no scales);
    returns (R4, F)."""
    f = x.shape[1]
    xp = _gather_rows(x, adj)
    out = torch.zeros((adj.n_tile_rows, TILE, f), dtype=x.dtype,
                      device=x.device)
    k = torch.arange(GROUP_COLS, dtype=torch.int64, device=x.device)
    for sl in _chunks(adj, GROUP_COLS * f):
        xg = xp[group_neighbor_ids(adj.col_idx[sl]).long()]      # (g, 32, F)
        words = bitops.as_u32(coarsen_groups(adj.tiles[sl]))    # (g, 4)
        mask = ((words[..., None] >> k) & 1).to(x.dtype)        # (g, 4, 32)
        out.index_add_(0, adj.group_row[sl].long(),
                       torch.einsum("gkn,gnf->gkf", mask, xg))
    return out.reshape(-1, f)


def _check_adj(adj: FRDCMatrix, x: torch.Tensor, what: str) -> None:
    for name in ("grp_ptr", "tiles", "col_idx"):
        t = getattr(adj, name)
        if t.device != x.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: adj.{name} must be contiguous int32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if adj.grp_ptr.numel() != adj.n_tile_rows + 1:
        raise ValueError(f"{what}: grp_ptr has {adj.grp_ptr.numel()} entries "
                         f"for {adj.n_tile_rows} tile-rows")


def _work_items(adj: FRDCMatrix):
    """(item_ptr, max_items, row_done) for the CUDA kernels: tile-row r owns
    work items item_ptr[r] .. item_ptr[r+1] (max(1, ceil(groups /
    GROUPS_PER_ITEM)) of them); ``max_items`` bounds item_ptr[-1] without a
    device sync and sizes the grid and the partial-sum scratch."""
    r = adj.n_tile_rows
    per = adj.grp_ptr[1:] - adj.grp_ptr[:-1]
    items = torch.clamp(torch.div(per + GROUPS_PER_ITEM - 1, GROUPS_PER_ITEM,
                                  rounding_mode="floor"), min=1)
    item_ptr = torch.cat([items.new_zeros(1),
                          torch.cumsum(items, 0, dtype=torch.int32)])
    max_items = r + -(-adj.n_groups // GROUPS_PER_ITEM)
    row_done = torch.zeros(r, dtype=torch.int32, device=adj.device)
    return item_ptr, max_items, row_done


def bspmm_bits_cuda(adj: FRDCMatrix, x_packed: torch.Tensor, n_feat: int,
                    binarize: bool = True,
                    trinary_mode: str = "s3_two_popc") -> torch.Tensor:
    """Launch Algorithm 1 on CUDA: (R4, Wf*32) int32 counts or (R4, Wf)
    sign words."""
    if not x_packed.is_cuda or x_packed.dtype != torch.int32 \
            or x_packed.ndim != 2:
        raise ValueError("bspmm_bits_cuda takes 2-D CUDA int32 bit-view words, "
                         f"got {x_packed.dtype} on {x_packed.device}")
    if trinary_mode not in TRINARY_MODES:
        raise ValueError(trinary_mode)
    _check_adj(adj, x_packed, "bspmm_bits_cuda")
    x = x_packed.contiguous()
    n, wf = x.shape
    r4 = adj.n_tile_rows * TILE
    out = torch.empty((r4, wf if binarize else wf * WORD), dtype=torch.int32,
                      device=x.device)
    item_ptr, max_items, row_done = _work_items(adj)
    scratch = torch.empty(max_items * TILE * wf * WORD, dtype=torch.int32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.library("bspmm").bspmm_bits(
        item_ptr.data_ptr(), adj.grp_ptr.data_ptr(), adj.tiles.data_ptr(),
        adj.col_idx.data_ptr(), x.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), row_done.data_ptr(), adj.n_tile_rows, max_items,
        GROUPS_PER_ITEM, n, wf, int(n_feat), int(binarize),
        int(trinary_mode == "s2_and_andnot"), stream), "bspmm_bits")
    LAUNCHES["bspmm_bits"] += 1
    return out


def bspmm_fp_cuda(adj: FRDCMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch the fp FRDC kernel on a CUDA float32 (N, F) tensor; raw (no
    scales); returns (R4, F)."""
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError("bspmm_fp_cuda takes a 2-D CUDA float32 tensor, got "
                         f"{x.dtype} on {x.device}")
    _check_adj(adj, x, "bspmm_fp_cuda")
    x = x.contiguous()
    n, f = x.shape
    out = torch.empty((adj.n_tile_rows * TILE, f), dtype=torch.float32,
                      device=x.device)
    item_ptr, max_items, row_done = _work_items(adj)
    scratch = torch.empty(max_items * TILE * f, dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.library("bspmm").bspmm_fp(
        item_ptr.data_ptr(), adj.grp_ptr.data_ptr(), adj.tiles.data_ptr(),
        adj.col_idx.data_ptr(), x.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), row_done.data_ptr(), adj.n_tile_rows, max_items,
        GROUPS_PER_ITEM, n, f, stream), "bspmm_fp")
    LAUNCHES["bspmm_fp"] += 1
    return out
