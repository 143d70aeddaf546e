"""FRDC BSpMM kernels: Algorithm 1 on packed ±1 activations, and its fp twin.

Replaces the Pallas TPU kernels ``repro/kernels/bspmm_kernel.py:bspmm_bits``
(``_bits_kernel``, 1D grid) and ``bspmm_kernel.py:bspmm_fp`` (``_fp_kernel``,
1D grid) with ``csrc/bspmm.cu``, and their 2D block grids
(``_bspmm_bits_grid``, ``_bspmm_fp_grid``) with ``csrc/bspmm_grid.cu``; see
"2D block grid" below. The TPU kernels walk the flattened group
list on a sequential grid and keep the accumulator in VMEM across steps.
The CUDA kernels share one work split (``csrc/walk.cuh``
``split_block``): a warp walks a light tile-row whole, and a heavy one
(more than ``GROUPS_PER_ITEM`` groups in 1D) is cut into chunk items in
group space, which each warp finds from ``group_row`` and ``grp_ptr`` (see
:func:`heavy_items`), so a power-law hub row (1,399 groups on Flickr, mean
5) is spread over the whole launch and nothing is built before it; the
partial sums of a heavy row are added in chunk order by the warp that
finishes the row last, so results do not depend on scheduling.

* ``bspmm_bits``: Steps ②-⑤ of the paper's warp algorithm, for up to 4
  feature words a pass — lane k gathers neighbour k's words in one load,
  the eight 4x4 tiles are OR-reduced into four adjacency words once a group,
  each word's 32x32 bit block is transposed in registers by five
  ``__shfl_xor_sync`` rounds (LSB-first, so no ``__brev``), and each lane
  accumulates the trinary popc (s3 or s2) of one feature for the four rows.
  Binarize mode stores sign words with the tail past ``n_feat`` masked.
* ``bspmm_fp``: the edge-driven fp walk: per group a ballot finds the hit
  neighbour columns and the warp gathers only those, in a lane layout
  chosen by :func:`fp_layout`.

Both are bound by bytes on the H100 (gathered activation rows, group
arrays, output). Empty tile-rows store 0 (binarized: sign(0) = +1 bits with
the tail masked, the TPU prefill); ``pad_frdc`` bucket groups past
``grp_ptr[-1]`` are never visited; neighbour rows past the activation's row
count read as 0.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import bitops
from ..core.frdc import FRDCMatrix, GROUP_COLS, TILE, coarsen_groups, \
    group_neighbor_ids
from . import build, counting

WORD = 32
# CUDA launches (plain calls not counted)
LAUNCHES = {"bspmm_bits": 0, "bspmm_fp": 0, "bspmm_bits_grid": 0,
            "bspmm_fp_grid": 0}
ENTRIES = dict.fromkeys(LAUNCHES, 0)   # entries on either device (``counting``)
# groups per chunk of the plain versions: bounds their gathered temporaries
_CHUNK_ELEMS = 1 << 24
TRINARY_MODES = ("s2_and_andnot", "s3_two_popc")
GROUPS_PER_ITEM = 16   # groups of one tile-row per CUDA warp (walk.cuh kChunk);
                       # also the bits grid's kBitsHeavy
HEAVY_GRID = 32        # csrc/bspmm_grid.cu kHeavy: groups an fp grid warp walks whole


def _gather_rows(x: torch.Tensor, adj: FRDCMatrix) -> torch.Tensor:
    """x padded with zero rows so every gathered neighbour id is in range."""
    need = max(x.shape[0], -(-adj.n_cols // TILE) * TILE)
    pad = need - x.shape[0]
    return torch.nn.functional.pad(x, (0, 0, 0, pad)) if pad else x


def _chunks(adj: FRDCMatrix, per_group: int):
    step = max(1, _CHUNK_ELEMS // max(per_group, 1))
    for lo in range(0, adj.n_groups, step):
        yield slice(lo, min(lo + step, adj.n_groups))


def _bits_terms(adj: FRDCMatrix, xp: torch.Tensor, g,
                trinary_mode: str) -> torch.Tensor:
    """Algorithm 1 for groups ``g``: gather 32 neighbour rows of packed
    words ``xp``, bit-transpose, trinary popc against the coarsened
    adjacency words. Returns (len(g), TILE, Wf*32) int64 counts."""
    bg = xp[group_neighbor_ids(adj.col_idx[g]).long()]         # (g, 32, Wf)
    bt = bitops.as_u32(bitops.bit_transpose_32(bg.transpose(-1, -2)))
    a = bitops.as_u32(coarsen_groups(adj.tiles[g]))[:, :, None, None]
    b = bt[:, None, :, :]                                      # (g,1,Wf,32)
    if trinary_mode == "s3_two_popc":
        c = 2 * bitops.popcount(a & b) - bitops.popcount(a)
    else:
        c = bitops.popcount(a & b) - bitops.popcount(a & (b ^ bitops.MASK32))
    return c.reshape(c.shape[0], TILE, -1)


def _fp_terms(adj: FRDCMatrix, xp: torch.Tensor, g) -> torch.Tensor:
    """The fp kernel for groups ``g``: (4, 32) 0/1 mask times the (32, F)
    gathered rows of ``xp``. Returns (len(g), TILE, F)."""
    k = torch.arange(GROUP_COLS, dtype=torch.int64, device=xp.device)
    xg = xp[group_neighbor_ids(adj.col_idx[g]).long()]         # (g, 32, F)
    words = bitops.as_u32(coarsen_groups(adj.tiles[g]))       # (g, 4)
    mask = ((words[..., None] >> k) & 1).to(xp.dtype)         # (g, 4, 32)
    return torch.einsum("gkn,gnf->gkf", mask, xg)


@counting.entry_point(ENTRIES, "bspmm_bits")
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
        counts.index_add_(0, adj.group_row[sl].long(),
                          _bits_terms(adj, xp, sl, trinary_mode))
    counts = counts.reshape(-1, wf * WORD).to(torch.int32)
    if not binarize:
        return counts
    return bitops.pack_bits(counts[:, :n_feat] >= 0, axis=-1)


@counting.entry_point(ENTRIES, "bspmm_fp")
def bspmm_fp_plain(adj: FRDCMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fp kernel: gather, (4, 32) mask times
    (32, F) rows per group, ``index_add_`` per tile-row. Raw (no scales);
    returns (R4, F)."""
    f = x.shape[1]
    xp = _gather_rows(x, adj)
    out = torch.zeros((adj.n_tile_rows, TILE, f), dtype=x.dtype,
                      device=x.device)
    for sl in _chunks(adj, GROUP_COLS * f):
        out.index_add_(0, adj.group_row[sl].long(), _fp_terms(adj, xp, sl))
    return out.reshape(-1, f)


def _segment_rank(key: torch.Tensor) -> torch.Tensor:
    """Rank of each entry among the entries of equal ``key`` before it."""
    order = torch.sort(key, stable=True).indices
    _, counts = torch.unique_consecutive(key[order], return_counts=True)
    first = torch.repeat_interleave(torch.cumsum(counts, 0) - counts, counts)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=key.device) - first
    return rank


def bspmm_fp_walk_plain(adj: FRDCMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the 1D ``bspmm_fp`` kernel's summation order, bit for
    bit on the same float32 inputs (``csrc/walk.cuh``), where
    :func:`bspmm_fp_plain` sums in ``index_add_``'s order. Raw (no scales);
    returns (R4, F).

    The kernel's order: ``split_block`` with ``GROUPS_PER_ITEM``. A light
    tile-row (at most that many groups) is one walk; a heavy one a walk per
    chunk item in group space (:func:`heavy_items`). A walk takes its
    groups in batches of 4 from its first group; a batch's hits (a
    neighbour column with a row bit set, below x's row count) are listed in
    ascending group and bit order (bit 4 t + j: column j of tile t), and
    hit e goes to sub-warp ``e % (32 / sub)`` of :func:`fp_layout` (one
    sub-warp above 16 columns), which adds its hits in list order from 0.
    ``fold`` adds the sub-warps in its tree (s += s + S/2, then S/4, ...,
    1). A light row stores the folded sums; a heavy row adds its items'
    from 0 in chunk order."""
    f = x.shape[1]
    dev = x.device
    n_sub = WORD // fp_layout(f, f, 0).sub
    gp = adj.grp_ptr.long()
    out = torch.zeros((adj.n_tile_rows, TILE, f), dtype=x.dtype, device=dev)
    n_groups = int(gp[-1]) if gp.numel() else 0
    if n_groups == 0 or f == 0:
        return out.reshape(-1, f)
    g = torch.arange(n_groups, device=dev)
    row = adj.group_row[:n_groups].long()
    heavy = (gp[1:] - gp[:-1] > GROUPS_PER_ITEM)[row]
    start = torch.where(
        heavy, torch.maximum(g // GROUPS_PER_ITEM * GROUPS_PER_ITEM, gp[row]),
        gp[row])
    first = g == start
    walk = torch.cumsum(first.long(), 0) - 1            # walk of each group
    # the hits of every group, in (group, bit) order: lane 4 t + j takes
    # column j of tile t, rows i with tile bit 4 i + j
    lane = torch.arange(WORD, device=dev)
    tile = adj.tiles[:n_groups].long()[:, lane // TILE]
    rows = (tile[..., None] >> (TILE * torch.arange(TILE, device=dev)
                                + (lane % TILE)[:, None])) & 1
    nbr = adj.col_idx[:n_groups].long()[:, lane // TILE] * TILE + lane % TILE
    hit = rows.any(-1) & (nbr < x.shape[0])
    hg = g[:, None].expand(-1, WORD)[hit]
    batch = walk[hg] * GROUPS_PER_ITEM + (hg - start[hg]) // 4
    sub = _segment_rank(batch) % n_sub
    seq = walk[hg] * n_sub + sub                        # a sub-warp's list
    pos = _segment_rank(seq)
    acc = torch.zeros((int(walk[-1]) + 1) * n_sub, TILE, f, dtype=x.dtype,
                      device=dev)
    bits, vals = rows[hit].bool(), nbr[hit]
    order = torch.sort(pos, stable=True).indices
    _, counts = torch.unique_consecutive(pos[order], return_counts=True)
    for idx in torch.split(order, counts.tolist()) if pos.numel() else ():
        term = torch.where(bits[idx][:, :, None], x[vals[idx]][:, None, :],
                           x.new_zeros(()))
        acc[seq[idx]] = acc[seq[idx]] + term
    acc = acc.view(-1, n_sub, TILE, f)
    d = n_sub // 2
    while d:
        acc = acc[:, :d] + acc[:, d:2 * d]
        d //= 2
    acc = acc[:, 0]
    w_row, w_heavy = row[first], heavy[first]
    out[w_row[~w_heavy]] = acc[~w_heavy]
    k = _segment_rank(w_row)                            # item of its row
    for j in range(int(k[w_heavy].max()) + 1 if bool(w_heavy.any()) else 0):
        sel = w_heavy & (k == j)
        out[w_row[sel]] = out[w_row[sel]] + acc[sel]
    return out.reshape(-1, f)


def _check_adj(adj: FRDCMatrix, x: torch.Tensor, what: str) -> None:
    for name in ("grp_ptr", "group_row", "tiles", "col_idx"):
        t = getattr(adj, name)
        if t.device != x.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{what}: adj.{name} must be contiguous int32 on "
                             f"{x.device}, got {t.dtype} on {t.device}")
    if adj.grp_ptr.numel() != adj.n_tile_rows + 1:
        raise ValueError(f"{what}: grp_ptr has {adj.grp_ptr.numel()} entries "
                         f"for {adj.n_tile_rows} tile-rows")


def work_items(grp_ptr: torch.Tensor) -> torch.Tensor:
    """The aggregating fused kernels' items of each tile-row, (R+1,) int32
    offsets: tile-row r has items [out[r], out[r+1]), max(1, ceil(groups /
    GROUPS_PER_ITEM)) of them (``fused_layer.pair_items`` counts them)."""
    per = grp_ptr[1:] - grp_ptr[:-1]
    items = torch.clamp(torch.div(per + GROUPS_PER_ITEM - 1, GROUPS_PER_ITEM,
                                  rounding_mode="floor"), min=1)
    return torch.cat([items.new_zeros(1),
                      torch.cumsum(items, 0, dtype=torch.int32)])


class FpLayout(NamedTuple):
    """Lane layout of the fp walk (``csrc/walk.cuh`` ``FpLanes``).

    ``sub``: lanes of a sub-warp; the warp's 32 // sub sub-warps gather
    separate hit neighbours. ``cols``: columns a lane takes in one pass.
    ``vec``: a lane's columns come as one float2 / float4 load.
    """
    sub: int
    cols: int
    vec: bool


def fp_layout(width: int, f: int, base_ptr: int) -> FpLayout:
    """The fp kernels' lane layout for passes ``width`` columns wide (the
    feature block) over rows of ``f`` floats starting at byte address
    ``base_ptr``. A width of at most 16 rounds up to a power-of-two
    sub-warp; wider ones take the whole warp, 2 columns a lane up to 64 and
    4 above, as one vector load only where every row and block start is
    aligned to it."""
    if width <= 16:
        return FpLayout(1 << (width - 1).bit_length(), 1, False)
    cols = 1 if width <= WORD else 2 if width <= 2 * WORD else 4
    vec = (cols > 1 and f % cols == 0 and width % cols == 0
           and base_ptr % (4 * cols) == 0)
    return FpLayout(WORD, cols, vec)


def heavy_items(grp_ptr: torch.Tensor, group_row: torch.Tensor,
                heavy: int) -> list:
    """The 1D and grid kernels' work items of heavy tile-rows (more than
    ``heavy`` groups), as ``(chunk, slot, row, g0, g1)`` in chunk order.

    The kernels build nothing for them: warp k takes chunk k, the groups
    [k * GROUPS_PER_ITEM, (k + 1) * GROUPS_PER_ITEM) below ``grp_ptr[-1]``,
    reads the tile-rows of its first and last group (``group_row``) and
    walks the parts of heavy ones: slot 0 for the row of its first group,
    slot 1 for a row that starts inside the chunk. A tile-row's partial
    sums are added in chunk order. This is that split, on the host."""
    gp = grp_ptr.tolist()
    rows = group_row.tolist()
    c = GROUPS_PER_ITEM
    items = []
    for k in range(-(-gp[-1] // c)):
        lo, hi = k * c, min((k + 1) * c, gp[-1])
        for slot, r in enumerate((rows[lo], rows[hi - 1])):
            if slot and r == rows[lo]:
                break
            if gp[r + 1] - gp[r] > heavy:
                items.append((k, slot, r, max(lo, gp[r]), min(hi, gp[r + 1])))
    return items


def _work(adj: FRDCMatrix, width: int, n_fb: int, dtype: torch.dtype,
          device):
    """Scratch of the chunk items: two slots of (4, width) partial sums per
    ``GROUPS_PER_ITEM`` chunk, then one int32 ticket per tile-row and
    feature block at address ``tickets`` (zeroed by the launcher); one
    allocation, as the wrapper's host time is most of a call at serving
    widths. Returns (work, tickets)."""
    part = -(-adj.n_groups // GROUPS_PER_ITEM) * 2 * TILE * width
    work = torch.empty(part + adj.n_tile_rows * n_fb, dtype=dtype,
                       device=device)
    return work, work.data_ptr() + 4 * part


def _bits_args(adj: FRDCMatrix, x_packed: torch.Tensor, binarize: bool,
               trinary_mode: str, what: str):
    """Checks and output of the bits kernels: (x, out)."""
    if not x_packed.is_cuda or x_packed.dtype != torch.int32 \
            or x_packed.ndim != 2:
        raise ValueError(f"{what} takes 2-D CUDA int32 bit-view words, got "
                         f"{x_packed.dtype} on {x_packed.device}")
    if trinary_mode not in TRINARY_MODES:
        raise ValueError(trinary_mode)
    _check_adj(adj, x_packed, what)
    x = x_packed.contiguous()
    wf = x.shape[1]
    out = torch.empty((adj.n_tile_rows * TILE, wf if binarize else wf * WORD),
                      dtype=torch.int32, device=x.device)
    return x, out


@counting.entry_point(ENTRIES, "bspmm_bits")
def bspmm_bits_cuda(adj: FRDCMatrix, x_packed: torch.Tensor, n_feat: int,
                    binarize: bool = True,
                    trinary_mode: str = "s3_two_popc") -> torch.Tensor:
    """Launch Algorithm 1 on CUDA: (R4, Wf*32) int32 counts or (R4, Wf)
    sign words."""
    x, out = _bits_args(adj, x_packed, binarize, trinary_mode,
                        "bspmm_bits_cuda")
    n, wf = x.shape
    work, tickets = _work(adj, wf * WORD, 1, torch.int32, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.library("bspmm").bspmm_bits(
        adj.grp_ptr.data_ptr(), adj.group_row.data_ptr(), adj.tiles.data_ptr(),
        adj.col_idx.data_ptr(), x.data_ptr(), out.data_ptr(), work.data_ptr(),
        tickets, adj.n_tile_rows, adj.n_groups, n, wf, int(n_feat),
        int(binarize), int(trinary_mode == "s2_and_andnot"), stream),
        "bspmm_bits")
    LAUNCHES["bspmm_bits"] += 1
    return out


def _fp_launch_args(adj: FRDCMatrix, x: torch.Tensor, what: str,
                    plan: Optional[BlockPlan] = None):
    """Checks and buffers of the fp kernels: (x, out, work, tickets), the
    work buffer of :func:`_work` for the feature blocks of ``plan``."""
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"{what} takes a 2-D CUDA float32 tensor, got "
                         f"{x.dtype} on {x.device}")
    _check_adj(adj, x, what)
    x = x.contiguous()
    f = x.shape[1]
    n_fb = 1 if plan is None else _grid_geometry(adj, plan, f)[3]
    out = torch.empty((adj.n_tile_rows * TILE, f), dtype=torch.float32,
                      device=x.device)
    return (x, out, *_work(adj, f, n_fb, torch.float32, x.device))


@counting.entry_point(ENTRIES, "bspmm_fp")
def bspmm_fp_cuda(adj: FRDCMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch the fp FRDC kernel on a CUDA float32 (N, F) tensor; raw (no
    scales); returns (R4, F)."""
    x, out, work, tickets = _fp_launch_args(adj, x, "bspmm_fp_cuda")
    n, f = x.shape
    lay = fp_layout(f, f, x.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.library("bspmm").bspmm_fp(
        adj.grp_ptr.data_ptr(), adj.group_row.data_ptr(), adj.tiles.data_ptr(),
        adj.col_idx.data_ptr(), x.data_ptr(), out.data_ptr(),
        work.data_ptr(), tickets, adj.n_tile_rows, adj.n_groups, n, f,
        lay.sub, lay.cols, int(lay.vec), stream), "bspmm_fp")
    LAUNCHES["bspmm_fp"] += 1
    return out


# ---------------------------------------------------------------------------
# 2D block grid: multi-row output blocks x feature blocks
# ---------------------------------------------------------------------------
# One CUDA block owns ``rows`` output rows x one feature block, as one grid
# step of the TPU kernel does, and walks its tile-rows' ``grp_ptr`` ranges
# (``pad_frdc`` groups past ``grp_ptr[-1]`` are never visited). Warps take
# light tile-rows whole. A tile-row of more groups (``GROUPS_PER_ITEM`` in
# the bits grid, ``HEAVY_GRID`` in the fp grid) leaves its block: it is cut into the chunk items of :func:`heavy_items`,
# spread over the whole launch and added in chunk order, as in the 1D
# kernels; the results are deterministic (``csrc/bspmm_grid.cu``).

class BlockPlan(NamedTuple):
    """Resolved (rows, feats) block tunable for the 2D grid.

    ``rows``: output rows per grid step — a positive multiple of TILE.
    ``feats``: feature width per grid step, or None for the full width.
    """
    rows: int
    feats: Optional[int]


def block_probe(block_shape, f: int, packed_width: bool) -> Optional[str]:
    """Capability probe for a (rows, feats) block shape: ``None`` when the
    grid supports it, else ONE message naming the violation AND the legal
    block-shape space (word alignment, real feature width) — callers get the
    whole picture from any rejection instead of three divergent branches."""
    if block_shape is None:
        return None
    if packed_width:
        feat_space = (f"a positive multiple of the {WORD}-bit word or "
                      f"exactly the real feature width {f} (packed kernels "
                      f"carry word-native features)")
    else:
        feat_space = (f"any positive width (the fp feature dim is "
                      f"zero-padded to the block grid; real width {f})")
    space = (f"legal BSpMM block shapes: rows = a positive multiple of the "
             f"FRDC tile-row height {TILE}; feats = None (full width) or "
             f"{feat_space}")
    rows, feats = block_shape
    rows = int(rows)
    if rows <= 0 or rows % TILE:
        return (f"unsupported bspmm block {tuple(block_shape)!r}: rows "
                f"{rows} is not a positive multiple of {TILE}; {space}")
    if feats is None:
        return None
    feats = int(feats)
    if feats <= 0:
        return (f"unsupported bspmm block {tuple(block_shape)!r}: feats "
                f"{feats} is not positive; {space}")
    if packed_width and feats % WORD and feats != f:
        return (f"unsupported bspmm block {tuple(block_shape)!r}: feats "
                f"{feats} is neither word-aligned nor the real feature "
                f"width; {space}")
    return None


def _block_plan(block_shape, f: int, packed_width: bool) -> Optional[BlockPlan]:
    """Validate the tunable; None routes to the 1D grid, a BlockPlan to the
    2D grid."""
    reason = block_probe(block_shape, f, packed_width)
    if reason is not None:
        raise ValueError(reason)
    if block_shape is None:
        return None
    rows, feats = block_shape
    return BlockPlan(int(rows), None if feats is None else int(feats))


def _resolve_block(block_shape, f: int, packed_width: bool) -> int:
    """Validate the (rows, feats) block-shape tunable and return the padded
    feature width of one grid step's output row-block.

    Packed-word paths (``packed_width``) keep their word-native storage
    width; fp paths zero-pad the feature dimension up to a multiple of the
    block width (exact). Rejections carry the full legal block-shape space —
    see :func:`block_probe`, which is also the non-raising capability test.
    """
    plan = _block_plan(block_shape, f, packed_width)
    if plan is None or plan.feats is None or packed_width:
        return f
    return -(-f // plan.feats) * plan.feats


def _grid_geometry(adj: FRDCMatrix, plan: BlockPlan, width: int):
    """(tb_rows, n_rb, fw, n_fb): tile-rows per row block, row blocks,
    feature (or word) block width, feature blocks."""
    tb_rows = plan.rows // TILE
    n_rb = -(-adj.n_tile_rows // tb_rows)
    fw = width if plan.feats is None else min(plan.feats, width)
    n_fb = -(-width // fw)
    return tb_rows, n_rb, fw, n_fb


def _bits_word_plan(plan: BlockPlan) -> BlockPlan:
    """The bits grid blocks words: a word-aligned ``feats`` becomes a word
    count, a real-width one the full width."""
    feats_w = None if (plan.feats is None or plan.feats % WORD) \
        else plan.feats // WORD
    return BlockPlan(plan.rows, feats_w)


# The grid changes the order in which groups are summed, never the sums: the
# trinary counts are integers (exact in any order) and the fp sums are held
# to a tolerance of their sum of |terms|, which no order changes. So the
# grids' plain versions are the 1D plain versions, the one reference of all
# three BSpMM kernels (1D, grid, fused).

@counting.entry_point(ENTRIES, "bspmm_bits_grid")
def bspmm_bits_grid_plain(adj: FRDCMatrix, x_packed: torch.Tensor,
                          n_feat: int, binarize: bool = True,
                          trinary_mode: str = "s3_two_popc",
                          plan: BlockPlan = BlockPlan(TILE, None)
                          ) -> torch.Tensor:
    """Plain version of the 2D grid over packed ±1 activations: (R4,
    Wf*32) int32 counts or (R4, Wf) sign words, the tail of word
    ``n_feat // 32`` masked. ``plan`` does not change the result."""
    del plan
    return bspmm_bits_plain(adj, x_packed, n_feat, binarize, trinary_mode)


@counting.entry_point(ENTRIES, "bspmm_fp_grid")
def bspmm_fp_grid_plain(adj: FRDCMatrix, x: torch.Tensor,
                        plan: BlockPlan = BlockPlan(TILE, None)
                        ) -> torch.Tensor:
    """Plain version of the 2D grid over fp activations; raw (no scales);
    returns (R4, F). The kernel's zero-padding of F to the feature blocks
    is cropped away, so ``plan`` does not change the result."""
    del plan
    return bspmm_fp_plain(adj, x)


@counting.entry_point(ENTRIES, "bspmm_bits_grid")
def bspmm_bits_grid_cuda(adj: FRDCMatrix, x_packed: torch.Tensor,
                         n_feat: int, binarize: bool = True,
                         trinary_mode: str = "s3_two_popc",
                         plan: BlockPlan = BlockPlan(TILE, None)
                         ) -> torch.Tensor:
    """Launch the 2D grid over packed ±1 activations: (R4, Wf*32) int32
    counts or (R4, Wf) sign words."""
    x, out = _bits_args(adj, x_packed, binarize, trinary_mode,
                        "bspmm_bits_grid_cuda")
    n, wf = x.shape
    tb_rows, _, fbw, n_fb = _grid_geometry(adj, _bits_word_plan(plan), wf)
    work, tickets = _work(adj, wf * WORD, n_fb, torch.int32, x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.library("bspmm_grid").bspmm_bits_grid(
        adj.grp_ptr.data_ptr(), adj.group_row.data_ptr(), adj.tiles.data_ptr(),
        adj.col_idx.data_ptr(), x.data_ptr(), out.data_ptr(), work.data_ptr(),
        tickets, adj.n_tile_rows, adj.n_groups, tb_rows, fbw, n, wf,
        int(n_feat), int(binarize), int(trinary_mode == "s2_and_andnot"),
        stream), "bspmm_bits_grid")
    LAUNCHES["bspmm_bits_grid"] += 1
    return out


@counting.entry_point(ENTRIES, "bspmm_fp_grid")
def bspmm_fp_grid_cuda(adj: FRDCMatrix, x: torch.Tensor,
                       plan: BlockPlan = BlockPlan(TILE, None)
                       ) -> torch.Tensor:
    """Launch the 2D grid over a CUDA float32 (N, F) tensor; raw (no
    scales); returns (R4, F)."""
    x, out, work, tickets = _fp_launch_args(adj, x, "bspmm_fp_grid_cuda",
                                            plan)
    n, f = x.shape
    tb_rows, n_rb, fw, n_fb = _grid_geometry(adj, plan, f)
    lay = fp_layout(fw, f, x.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(build.library("bspmm_grid").bspmm_fp_grid(
        adj.grp_ptr.data_ptr(), adj.group_row.data_ptr(), adj.tiles.data_ptr(),
        adj.col_idx.data_ptr(), x.data_ptr(), out.data_ptr(),
        work.data_ptr(), tickets, adj.n_tile_rows, adj.n_groups, tb_rows,
        n_rb, fw, n_fb, n, f, lay.sub, lay.cols, int(lay.vec), stream),
        "bspmm_fp_grid")
    LAUNCHES["bspmm_fp_grid"] += 1
    return out
