"""FRDC bit-sparse format in PyTorch (reference: ``repro/core/frdc.py``).

Storage is built on the host with numpy exactly as the reference builds it:
the adjacency is cut into 4x4 bit-tiles, only non-empty tiles are kept, and
the tiles of one tile-row are grouped eight at a time (one group covers 32
gathered columns, one machine word). The arrays then move to ``device``:

* ``tiles`` (G, 8) int32 — 4x4 bit-tiles, LSB = (r0, c0). The reference
  keeps them as uint16; int32 holds the same values and is what the CUDA
  kernels read.
* ``col_idx`` (G, 8) int32, ``group_row`` (G,) int32, ``group_first`` (G,)
  int32, ``grp_ptr`` (R+1,) int32.
* optional positive ``row_scale`` / ``col_scale`` float32 vectors: the exact
  factorization ``diag(r) @ A_bin @ diag(c)`` of a normalized adjacency.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels import counting

TILE = 4                # fine tile side (paper's 4x4 choice)
GROUP = 8               # tiles per group: 8 * 4 = 32 columns = one word
GROUP_COLS = TILE * GROUP  # 32


class FRDCMatrix(NamedTuple):
    """Device-resident FRDC sparse bit-matrix."""
    tiles: torch.Tensor        # (G, GROUP) int32
    col_idx: torch.Tensor      # (G, GROUP) int32 — tile-column index (pad: 0)
    group_row: torch.Tensor    # (G,) int32 — tile-row of each group
    group_first: torch.Tensor  # (G,) int32 — 1 iff first group of its tile-row
    grp_ptr: torch.Tensor      # (R+1,) int32 — group extents per tile-row
    n_rows: int
    n_cols: int
    nnz: int                   # true number of edges (pre-padding)
    row_scale: Optional[torch.Tensor] = None
    col_scale: Optional[torch.Tensor] = None

    @property
    def n_tile_rows(self) -> int:
        return -(-self.n_rows // TILE)

    @property
    def n_groups(self) -> int:
        return int(self.tiles.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    def nbytes(self) -> int:
        """Bytes of the bit representation (paper's Peak-Mem metric), with
        tiles counted at the format's 16 bits as in the reference."""
        total = self.tiles.numel() * 2 + self.col_idx.numel() * 4
        total += self.group_row.numel() * 4 + self.group_first.numel() * 4
        total += self.grp_ptr.numel() * 4
        for s in (self.row_scale, self.col_scale):
            if s is not None:
                total += s.numel() * s.element_size()
        return int(total)

    def to(self, device) -> "FRDCMatrix":
        """The same matrix with every tensor on ``device``."""
        def mv(t):
            return None if t is None else t.to(device)
        return self._replace(
            tiles=mv(self.tiles), col_idx=mv(self.col_idx),
            group_row=mv(self.group_row), group_first=mv(self.group_first),
            grp_ptr=mv(self.grp_ptr), row_scale=mv(self.row_scale),
            col_scale=mv(self.col_scale))


def from_coo(rows: np.ndarray, cols: np.ndarray, n_rows: int, n_cols: int,
             row_scale: Optional[np.ndarray] = None,
             col_scale: Optional[np.ndarray] = None,
             device="cuda") -> FRDCMatrix:
    """Build FRDC from an edge list on the host, then move it to ``device``.
    Records the set-up span ``frdc.from_coo`` around its phases
    ``frdc.tiles``, ``frdc.groups`` and ``frdc.upload``."""
    with counting.setup_span("frdc.from_coo"):
        return _from_coo(rows, cols, n_rows, n_cols, row_scale, col_scale,
                         device)


def _from_coo(rows, cols, n_rows, n_cols, row_scale, col_scale, device):
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if rows.size and (rows.max() >= n_rows or cols.max() >= n_cols):
        raise ValueError(f"edge index out of range for ({n_rows},{n_cols})")
    n_tr = -(-n_rows // TILE)
    n_tc = -(-n_cols // TILE)

    with counting.setup_span("frdc.tiles"):
        tile_r, in_r = np.divmod(rows, TILE)
        tile_c, in_c = np.divmod(cols, TILE)
        tile_id = tile_r * n_tc + tile_c
        uniq, inv = np.unique(tile_id, return_inverse=True)
        bits = np.zeros(uniq.shape[0], np.uint16)
        np.bitwise_or.at(bits, inv, (np.uint16(1) << (
            in_r * TILE + in_c).astype(np.uint16)))
        utile_r = (uniq // n_tc).astype(np.int64)
        utile_c = (uniq % n_tc).astype(np.int64)

    with counting.setup_span("frdc.groups"):
        # np.unique sorts tile_id == (tile_r, tile_c) lexicographically:
        # CSR order
        row_counts = np.bincount(utile_r, minlength=n_tr)
        grp_counts = -(-row_counts // GROUP)
        G = max(int(grp_counts.sum()), 1)  # keep shapes non-empty

        tiles = np.zeros((G, GROUP), np.int32)
        col_idx = np.zeros((G, GROUP), np.int32)
        group_row = np.zeros((G,), np.int32)
        group_first = np.zeros((G,), np.int32)
        grp_ptr = np.zeros(n_tr + 1, np.int32)

        row_ptr = np.zeros(n_tr + 1, np.int64)
        np.cumsum(row_counts, out=row_ptr[1:])
        g = 0
        for r in range(n_tr):
            grp_ptr[r] = g
            lo, hi = row_ptr[r], row_ptr[r + 1]
            nt = hi - lo
            if nt == 0:
                continue
            ng = -(-nt // GROUP)
            row_tiles = np.zeros(ng * GROUP, np.int32)
            row_cols = np.zeros(ng * GROUP, np.int32)
            row_tiles[:nt] = bits[lo:hi]
            row_cols[:nt] = utile_c[lo:hi]
            tiles[g:g + ng] = row_tiles.reshape(ng, GROUP)
            col_idx[g:g + ng] = row_cols.reshape(ng, GROUP)
            group_row[g:g + ng] = r
            group_first[g] = 1
            g += ng
        grp_ptr[n_tr] = g
        if g == 0:  # degenerate: single zero group mapped to row 0
            group_first[0] = 1

    def dev(a, dtype=None):
        if a is None:
            return None
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    with counting.setup_span("frdc.upload"):
        return FRDCMatrix(
            tiles=dev(tiles), col_idx=dev(col_idx), group_row=dev(group_row),
            group_first=dev(group_first), grp_ptr=dev(grp_ptr),
            n_rows=int(n_rows), n_cols=int(n_cols), nnz=int(rows.size),
            row_scale=dev(row_scale, np.float32),
            col_scale=dev(col_scale, np.float32))


def from_dense(a: np.ndarray, **kw) -> FRDCMatrix:
    r, c = np.nonzero(np.asarray(a) != 0)
    return from_coo(r, c, a.shape[0], a.shape[1], **kw)


def gcn_normalized(rows: np.ndarray, cols: np.ndarray, n: int,
                   add_self_loops: bool = True, device="cuda") -> FRDCMatrix:
    """FRDC of ``D^-1/2 (A+I) D^-1/2`` — exact binary factorization (GCN)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    if add_self_loops:
        loop = np.arange(n, dtype=np.int64)
        rows = np.concatenate([rows, loop])
        cols = np.concatenate([cols, loop])
    deg = np.bincount(rows, minlength=n).astype(np.float64)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    return from_coo(rows, cols, n, n, row_scale=dinv, col_scale=dinv,
                    device=device)


def mean_normalized(rows: np.ndarray, cols: np.ndarray, n: int,
                    device="cuda") -> FRDCMatrix:
    """FRDC of ``D^-1 A`` — mean aggregator (SAGEConv)."""
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    deg = np.bincount(rows, minlength=n).astype(np.float64)
    dinv = 1.0 / np.maximum(deg, 1.0)
    return from_coo(rows, cols, n, n, row_scale=dinv, col_scale=None,
                    device=device)


# ---------------------------------------------------------------------------
# Dynamic coarsening
# ---------------------------------------------------------------------------

def coarsen_groups(tiles: torch.Tensor) -> torch.Tensor:
    """Stitch (..., GROUP) 4x4 tiles into (..., TILE) int32 bit-view words.

    Word ``i`` has bit ``t*4+j`` set iff tile ``t`` has bit ``i*4+j`` set:
    the eight tiles concatenated horizontally (the paper's Step ③).
    """
    t = tiles.to(torch.int64)
    dev = t.device
    j = torch.arange(TILE, dtype=torch.int64, device=dev)
    i = torch.arange(TILE, dtype=torch.int64, device=dev)
    tpos = torch.arange(GROUP, dtype=torch.int64, device=dev)
    # bit (i*4 + j) of tile t  ->  bit (t*4 + j) of word i
    bits = (t[..., None, :, None] >> (i[:, None, None] * TILE + j)) & 1
    words = (bits << (tpos[:, None] * TILE + j)).sum(dim=(-2, -1))
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def group_neighbor_ids(col_idx: torch.Tensor) -> torch.Tensor:
    """(..., GROUP) tile-columns -> (..., GROUP_COLS) gathered column ids."""
    offs = torch.arange(TILE, dtype=col_idx.dtype, device=col_idx.device)
    return (col_idx[..., :, None] * TILE + offs).reshape(
        *col_idx.shape[:-1], GROUP_COLS)


def pad_frdc(m: FRDCMatrix, n_rows: int, n_cols: Optional[int] = None,
             n_groups: Optional[int] = None) -> FRDCMatrix:
    """Zero-pad an FRDC matrix to fixed bucket dimensions.

    Padded groups hold zero tiles mapped to tile-row 0 past ``grp_ptr[-1]``;
    they contribute nothing to any aggregation. As in the reference, the
    BSpMM ``B?F`` variants rescale by the global ``mean(col_scale)``, which
    column padding (scale 1.0) shifts, so those two are not
    padding-invariant on scaled adjacencies.
    """
    n_cols = n_rows if n_cols is None else n_cols
    if n_rows < m.n_rows or n_cols < m.n_cols:
        raise ValueError(f"bucket ({n_rows},{n_cols}) smaller than matrix "
                         f"({m.n_rows},{m.n_cols})")
    g = m.n_groups
    n_groups = g if n_groups is None else max(n_groups, g)
    pad_g = n_groups - g
    n_tr = -(-n_rows // TILE)
    grp_ptr = torch.cat([m.grp_ptr, m.grp_ptr[-1:].expand(n_tr - m.n_tile_rows)])

    def pad_rows(t):
        return torch.cat([t, t.new_zeros((pad_g, *t.shape[1:]))])

    def pad_scale(s, n_old, n_new):
        if s is None:
            return None
        return torch.cat([s, s.new_ones(n_new - n_old)])

    return FRDCMatrix(
        tiles=pad_rows(m.tiles), col_idx=pad_rows(m.col_idx),
        group_row=pad_rows(m.group_row), group_first=pad_rows(m.group_first),
        grp_ptr=grp_ptr, n_rows=int(n_rows), n_cols=int(n_cols), nnz=m.nnz,
        row_scale=pad_scale(m.row_scale, m.n_rows, n_rows),
        col_scale=pad_scale(m.col_scale, m.n_cols, n_cols))


def align_tile(n: int) -> int:
    """Round up to the tile grid (min one tile): the per-shard uniform dims
    of the sharded layer executors are tile-aligned so every shard's padded
    FRDC block and operand rows share one shape."""
    return -(-max(int(n), 1) // TILE) * TILE


def pad_frdc_uniform(mats, n_rows: int, n_cols: int, n_groups: int) -> list:
    """Pad a per-shard family of FRDC matrices to ONE shape: ``(n_rows,
    n_cols)`` tile-aligned covers of every matrix and ``n_groups`` a cover
    of every group count. Exact for the serving variants (see
    :func:`pad_frdc`)."""
    if n_rows % TILE or n_cols % TILE:
        raise ValueError(f"uniform dims ({n_rows},{n_cols}) must be "
                         f"TILE({TILE})-aligned")
    return [pad_frdc(m, n_rows, n_cols, n_groups=n_groups) for m in mats]


def stack_frdc(mats) -> dict:
    """Stack uniformly padded FRDC matrices along a new leading shard axis.

    Returns the field dict (``tiles``/``col_idx``/``group_row``/
    ``group_first``/``grp_ptr`` + present scale vectors), each ``(P, ...)``:
    row ``s`` of every field, rebuilt with the shared dims, is shard
    ``s``'s matrix (the SPMD executor's operands)."""
    m0 = mats[0]
    for m in mats[1:]:
        if (m.n_rows, m.n_cols, m.n_groups) != (m0.n_rows, m0.n_cols,
                                                m0.n_groups):
            raise ValueError(
                f"stack_frdc needs uniformly padded matrices, got "
                f"({m.n_rows},{m.n_cols},g{m.n_groups}) vs "
                f"({m0.n_rows},{m0.n_cols},g{m0.n_groups})")
        for f in ("row_scale", "col_scale"):
            if (getattr(m, f) is None) != (getattr(m0, f) is None):
                raise ValueError(f"stack_frdc: {f} present on some shards "
                                 "but not others")
    out = {f: torch.stack([getattr(m, f) for m in mats])
           for f in ("tiles", "col_idx", "group_row", "group_first",
                     "grp_ptr")}
    for f in ("row_scale", "col_scale"):
        if getattr(m0, f) is not None:
            out[f] = torch.stack([getattr(m, f) for m in mats])
    return out

def nonzero_coords(m: FRDCMatrix) -> tuple:
    """(rows, cols) of the matrix's ones, decoded from its tiles on the
    host as int64 arrays (a pad group's tiles are 0 and add nothing)."""
    tiles = m.tiles.cpu().numpy()
    col_idx = m.col_idx.cpu().numpy().astype(np.int64)
    group_row = m.group_row.cpu().numpy().astype(np.int64)
    g_idx, t_idx = np.nonzero(tiles)
    t = tiles[g_idx, t_idx]
    rows, cols = [], []
    for i in range(TILE):
        for j in range(TILE):
            hit = (t >> (i * TILE + j)) & 1 == 1
            rows.append(group_row[g_idx[hit]] * TILE + i)
            cols.append(col_idx[g_idx[hit], t_idx[hit]] * TILE + j)
    return np.concatenate(rows), np.concatenate(cols)


def to_dense(m: FRDCMatrix, dtype=torch.float32,
             apply_scales: bool = True) -> torch.Tensor:
    """Decode to a dense matrix on ``m``'s device — the BSpMM test oracle."""
    rows, cols = nonzero_coords(m)
    out = np.zeros((m.n_tile_rows * TILE, -(-m.n_cols // TILE) * TILE),
                   np.float32)
    out[rows, cols] = 1.0
    out = out[:m.n_rows, :m.n_cols]
    if apply_scales:
        if m.row_scale is not None:
            out = out * m.row_scale.cpu().numpy()[:, None]
        if m.col_scale is not None:
            out = out * m.col_scale.cpu().numpy()[None, :]
    return torch.from_numpy(np.ascontiguousarray(out)).to(m.device, dtype)


def to_sparse(m: FRDCMatrix, transpose: bool = False) -> torch.Tensor:
    """The float32 matrix of :func:`to_dense`, with the same values, as a
    sparse CSR tensor on ``m``'s device (its transpose with
    ``transpose``): what the training forwards multiply by on the card,
    where a dense full-graph adjacency does not fit (Flickr's is 89,250^2
    x 4 B = 31.9 GB). A value is ``row_scale[r] * col_scale[c]`` in
    float32, the product :func:`to_dense` forms."""
    rows, cols = nonzero_coords(m)
    vals = np.ones(rows.size, np.float32)
    if m.row_scale is not None:
        vals = vals * m.row_scale.cpu().numpy()[rows]
    if m.col_scale is not None:
        vals = vals * m.col_scale.cpu().numpy()[cols]
    shape = (m.n_rows, m.n_cols)
    if transpose:
        rows, cols, shape = cols, rows, shape[::-1]
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    crow = np.zeros(shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=shape[0]), out=crow[1:])
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        warnings.filterwarnings("ignore", "Sparse invariant checks")
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow), torch.from_numpy(cols),
            torch.from_numpy(vals), size=shape).to(m.device)


def stats(m: FRDCMatrix) -> dict:
    """Space accounting vs. fp32-CSR and dense-bit (paper Tables 3-5)."""
    nz_tiles = int((m.tiles != 0).sum())
    slots = m.tiles.numel()
    bit_slots = nz_tiles * TILE * TILE
    csr_fp32 = m.nnz * 8 + (m.n_rows + 1) * 4           # val+col + ptr
    dense_bits = m.n_rows * (-(-m.n_cols // 32)) * 4
    return dict(
        n_rows=m.n_rows, n_cols=m.n_cols, nnz=m.nnz,
        n_tiles=nz_tiles, n_groups=m.n_groups,
        pad_fraction=1.0 - nz_tiles / max(slots, 1),
        bits_per_edge=bit_slots / max(m.nnz, 1),
        frdc_bytes=m.nbytes(), csr_fp32_bytes=int(csr_fp32),
        dense_bit_bytes=int(dense_bits),
        vs_csr=csr_fp32 / max(m.nbytes(), 1),
    )
