"""SparseTensor: the sorted voxel table, its input layer and rulebooks.

Counterpart of detection_3d_tpu/ops/sparse.py. A SparseTensor keeps

  * ``coords`` (V, 4) int32 [x, y, z, b] — active sites sorted by key;
    padding rows carry INVALID coords and sort last;
  * ``feats`` (V, C) — active-site features (padding rows are zero);
  * ``hi``/``lo`` (V,) int32 — the sorted key pair, and ``keys`` (V,)
    int64 — the same order as one composite key (ops/coords.py);
  * ``num`` 0-d int32 tensor — number of active rows; ``true_num`` the
    pre-truncation voxel count;
  * ``spatial_size`` (X, Y, Z) and ``batch_size``.

V is a static capacity and every op masks with ``row_valid``. The JAX
package's dense 3D grid and xy-column grid are lookup accelerators for
the TPU; the port answers every lookup with one int64 search instead,
and the integers come out identical.

The 27-offset submanifold rulebook has a hand-written CUDA kernel, B
(csrc/subm_match.cu). It searches columns, not offsets: the three dz
neighbours of (x+dx, y+dy) hold keys q-1, q, q+1, so one lower-bound
search per column (8 a site; the centre column is the site and its
adjacent rows) finds all three among three consecutive rows. On tables
of SUBM_WINDOW_MIN_ROWS rows and more each block searches short windows
of the table staged in shared memory; smaller tables, which sit in
L1/L2, are searched whole. The same pass writes each row's offset mask,
from which the pyramid takes the book's row order.
:func:`neighbor_match_3x3x3` returns the book and its masks: it launches
kernel B for a table on the card and takes the plain
:func:`neighbor_match_columns` (the same algorithm) for a table on the
CPU; :func:`neighbor_indices` (one search per offset) stays the
reference.
"""

from __future__ import annotations

from typing import Tuple

import torch

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.coords import (
    INVALID, composite_key, key_search, pack_key,
)


class SparseTensor:
    """Sorted sparse voxel table (see the module docstring)."""

    def __init__(self, coords, feats, hi, lo, num, spatial_size, batch_size,
                 true_num=None, keys=None):
        self.coords = coords
        self.feats = feats
        self.hi = hi
        self.lo = lo
        self.num = num
        self.spatial_size = tuple(int(s) for s in spatial_size)
        self.batch_size = int(batch_size)
        self.true_num = num if true_num is None else true_num
        self.keys = composite_key(hi, lo) if keys is None else keys

    @property
    def capacity(self) -> int:
        return self.coords.shape[0]

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def row_valid(self):
        return torch.arange(self.capacity, device=self.device) < self.num

    def with_feats(self, feats) -> "SparseTensor":
        return SparseTensor(self.coords, feats, self.hi, self.lo, self.num,
                            self.spatial_size, self.batch_size,
                            self.true_num, self.keys)

    def lookup(self, coords, valid=None):
        """Find rows for query coords (..., 4). Returns (idx, found)."""
        qhi, qlo = pack_key(coords, self.spatial_size, valid)
        return key_search(self.keys, qhi, qlo)


def build_sparse_tensor(coords, feats, valid, spatial_size, batch_size,
                        capacity: int, reduce: str = "mean",
                        return_row_map: bool = False):
    """Deduplicating input layer: raw voxel coords -> SparseTensor.

    Rows with equal (x, y, z, b) merge; ``reduce`` 'mean' averages their
    features ('sum' adds them). Out-of-grid and ``~valid`` rows are
    dropped. When more voxels than ``capacity`` exist, every k-th voxel
    (k = ceil(num / capacity)) is kept so coverage stays spatially
    uniform, and ``true_num`` keeps the pre-truncation count.

    Args:
      coords: (N, 4) int32 [x, y, z, b]; feats: (N, C); valid: (N,) bool
        or None; capacity: static output table size;
      return_row_map: also return (N,) int32 — for every INPUT row, the
        output row holding its voxel (== capacity when the row was invalid
        or its voxel was dropped by the overflow stride).
    """
    if reduce not in ("mean", "sum"):
        raise ValueError(f"reduce={reduce!r}: expected 'mean' or 'sum'")
    n = coords.shape[0]
    dev = coords.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    hi, lo = pack_key(coords, spatial_size, valid)
    keys, order = torch.sort(composite_key(hi, lo), stable=True)
    hi, lo = hi[order], lo[order]
    coords_s, feats_s = coords[order], feats[order]

    is_first = torch.ones((n,), dtype=torch.bool, device=dev)
    is_first[1:] = keys[1:] != keys[:-1]
    seg_id = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    key_ok = hi != INVALID
    num_vox = (is_first & key_ok).sum(dtype=torch.int32)

    # capacity overflow: keep every stride-th segment (see docstring)
    stride = torch.clamp(torch.div(num_vox + capacity - 1, capacity,
                                   rounding_mode="floor"), min=1)
    keep = torch.remainder(seg_id, stride) == 0
    slot = torch.div(seg_id, stride, rounding_mode="floor")
    row_on = key_ok & keep
    seg_c = torch.clamp(slot, max=capacity - 1).to(torch.int64)

    c = feats.shape[-1]
    out_feats = torch.zeros((capacity, c), dtype=feats.dtype, device=dev)
    if c:
        ones = row_on.to(feats.dtype)
        out_feats.index_add_(0, seg_c, feats_s * ones[:, None])
        if reduce == "mean":
            counts = torch.zeros((capacity,), dtype=feats.dtype, device=dev)
            counts.index_add_(0, seg_c, ones)
            out_feats = out_feats / torch.clamp(counts, min=1.0)[:, None]

    # representative coords/keys per segment (first occurrence)
    rows = torch.arange(n, device=dev)
    first_idx = torch.full((capacity,), n, dtype=torch.int64, device=dev)
    first_idx.scatter_reduce_(0, seg_c, torch.where(row_on, rows, n),
                              reduce="amin")
    in_range = first_idx < n
    gather_idx = torch.clamp(first_idx, max=n - 1)

    num = torch.minimum(torch.div(num_vox + stride - 1, stride,
                                  rounding_mode="floor"),
                        torch.tensor(capacity, dtype=torch.int32,
                                     device=dev))
    row_ok = torch.arange(capacity, device=dev) < num
    ok = in_range & row_ok
    out_coords = torch.where(ok[:, None], coords_s[gather_idx], INVALID)
    out_hi = torch.where(ok, hi[gather_idx], INVALID)
    out_lo = torch.where(ok, lo[gather_idx], INVALID)
    out_feats = torch.where(row_ok[:, None], out_feats, 0.0)
    table = SparseTensor(out_coords, out_feats, out_hi, out_lo, num,
                         spatial_size, batch_size, true_num=num_vox)
    if not return_row_map:
        return table
    slot_sorted = torch.where(row_on & (slot < num), slot, capacity)
    row_map = torch.empty_like(slot_sorted)
    row_map[order] = slot_sorted
    return table, row_map


def submanifold_offsets(kernel: Tuple[int, int, int]):
    """Centered kernel offsets for submanifold conv (odd kernel sizes),
    dx outer, dz inner."""
    kx, ky, kz = kernel
    offs = []
    for dx in range(-(kx // 2), kx // 2 + 1):
        for dy in range(-(ky // 2), ky // 2 + 1):
            for dz in range(-(kz // 2), kz // 2 + 1):
                offs.append((dx, dy, dz))
    return tuple(offs)


def neighbor_indices(table: SparseTensor, offsets):
    """Per-offset gather indices into the table (the 'rulebook').

    (K, V) int32: idx[k, i] = row of the neighbour of site i at offset k,
    or V (the zero pad row) when absent, out of the grid, or site i is a
    pad row. This is the plain version of kernel B for 3x3x3 offsets.
    """
    v = table.capacity
    deltas = torch.tensor([[o[0], o[1], o[2], 0] for o in offsets],
                          dtype=torch.int32, device=table.device)
    out = torch.empty((len(offsets), v), dtype=torch.int32,
                      device=table.device)
    rv = table.row_valid
    for k in range(len(offsets)):   # one (V, 4) query block at a time
        idx, found = table.lookup(table.coords + deltas[k], valid=rv)
        out[k] = torch.where(found, idx, v)
    return out


def neighbor_match_columns(table: SparseTensor):
    """Kernel B's algorithm in plain PyTorch: ((27, V) int32 rulebook,
    (V,) int64 row masks), the book equal bit for bit to
    :func:`neighbor_indices` over the 3x3x3 offsets and bit k of mask i set
    where ``idx[k, i] < V`` (ops/sparse_conv.row_masks of the book).

    Per column (dx, dy) != (0, 0), one lower-bound search for the key t
    of (x+dx, y+dy, z-1) gives row p; the neighbour at dz is the row among
    p, p+1, p+2 whose key is t + 1 + dz. The centre column is the site
    (dz = 0) and the rows before and after it where their keys are the
    site's key -1 / +1. Out-of-grid columns, and dz = -1 / +1 at z = 0 /
    Z-1, are masked from the coords: a shifted key there is another
    voxel's key."""
    v = table.capacity
    X, Y, Z = table.spatial_size
    dev = table.device
    keys = table.keys
    x, y, z, b = table.coords.to(torch.int64).unbind(-1)
    rv = table.row_valid & (b >= 0)
    key = ((b * X + x) << 32) | (y * Z + z)
    rows = torch.arange(v, device=dev)
    z_ok = (z >= 1, torch.ones_like(rv), z + 1 < Z)
    out = torch.full((27, v), v, dtype=torch.int32, device=dev)
    masks = torch.zeros((v,), dtype=torch.int64, device=dev)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            k0 = 9 * (dx + 1) + 3 * (dy + 1)
            col_ok = (rv & (x + dx >= 0) & (x + dx < X) & (y + dy >= 0)
                      & (y + dy < Y))
            if dx == 0 and dy == 0:
                near = (torch.cat([keys[:1] - 2, keys[:-1]]) == key - 1,
                        torch.ones_like(rv),
                        torch.cat([keys[1:], keys[-1:] + 2]) == key + 1)
                cand = (rows - 1, rows, rows + 1)
                pos = [torch.where(near[dz], cand[dz], v) for dz in range(3)]
            else:
                t = key + (dx << 32) + dy * Z - 1
                p = torch.searchsorted(keys, t)
                pos = [torch.full_like(p, v) for _ in range(3)]
                for j in range(3):
                    inside = p + j < v
                    kj = keys[(p + j).clamp(max=v - 1)]
                    for dz in range(j, 3):    # keys rise: t + dz at <= p + dz
                        pos[dz] = torch.where(inside & (kj == t + dz), p + j,
                                              pos[dz])
            for dz in range(3):
                idx = torch.where(col_ok & z_ok[dz], pos[dz], v)
                out[k0 + dz] = idx.to(torch.int32)
                masks |= (idx < v).to(torch.int64) << (k0 + dz)
    return out, masks


# kernel B's windows: rows of each of a block's three shared-memory
# windows, and the table size from which they are used (below it the
# kernel searches the whole table, which sits in L1/L2)
SUBM_WINDOW = 1024
SUBM_WINDOW_MIN_ROWS = 65536


def subm_match_cuda(table: SparseTensor, window: int = None):
    """Kernel B on the card: the contract of :func:`neighbor_match_columns`.
    ``window`` >= 1 is the rows of each of a block's three shared-memory
    windows (3 * 8 * window bytes; a longer window is searched in global
    memory between its ends, with the same answers); 0 searches the whole
    table, 8 threads a site. None: SUBM_WINDOW from SUBM_WINDOW_MIN_ROWS
    rows, else 0."""
    v = table.capacity
    if window is None:
        window = SUBM_WINDOW if v >= SUBM_WINDOW_MIN_ROWS else 0
    X, Y, Z = table.spatial_size
    coords, keys = table.coords, table.keys
    num = table.num.reshape(1)
    if not (coords.dtype == torch.int32 and coords.shape == (v, 4)
            and keys.dtype == torch.int64 and keys.shape == (v,)
            and num.dtype == torch.int32 and coords.is_contiguous()
            and keys.is_contiguous() and keys.device == coords.device
            and num.device == coords.device and coords.is_cuda
            and 0 <= window and 3 * 8 * window <= cuda_lib.SHARED_BYTES):
        raise ValueError("subm_match_cuda: expected contiguous int32 coords "
                         "(V, 4), int64 keys (V,) and an int32 num on one "
                         "card, and three windows that fit shared memory")
    out = torch.empty((27, v), dtype=torch.int32, device=coords.device)
    masks = torch.empty((v,), dtype=torch.int64, device=coords.device)
    status = cuda_lib.library("subm_match").subm_match_3x3x3(
        keys.data_ptr(), coords.data_ptr(), num.data_ptr(), v, X, Y, Z,
        window, out.data_ptr(), masks.data_ptr(),
        cuda_lib.stream_ptr(coords.device))
    cuda_lib.check("subm_match", status)
    cuda_lib.launches["subm_match"] += 1
    return out, masks


def neighbor_match_3x3x3(table: SparseTensor):
    """((27, V) submanifold rulebook, its (V,) int64 row masks): kernel B
    on the card, the plain :func:`neighbor_match_columns` on the CPU.
    Equal bit for bit."""
    if table.coords.is_cuda:
        return subm_match_cuda(table)
    return neighbor_match_columns(table)


def downsample_with_rulebooks(table: SparseTensor, kernel, stride,
                              capacity: int):
    """Strided-conv output table + conv AND deconv rulebooks in one pass.

    Every (input row, output site, kernel offset) triple of the strided
    conv is expanded, the dedup sort of :func:`build_sparse_tensor`
    assigns each candidate its output row (``return_row_map``), and both
    rulebooks are single scatters of that mapping.

    Returns (out_table, conv_rb (K, capacity), deconv_rb (K, V_in)),
    int32, with pad entries V_in and capacity respectively.
    """
    ksz = tuple(kernel)
    st = tuple(stride)
    reach = [max(1, -(-k // s)) for k, s in zip(ksz, st)]
    out_size = tuple(-(-d // s) for d, s in zip(table.spatial_size, st))
    v_in = table.capacity
    kvol = ksz[0] * ksz[1] * ksz[2]
    dev = table.device

    x, y, z, b = table.coords.unbind(-1)
    rv = table.row_valid
    cand_coords, cand_valid, cand_koff = [], [], []
    for ax_off_x in range(reach[0]):
        for ax_off_y in range(reach[1]):
            for ax_off_z in range(reach[2]):
                # floor division, as jnp's // on int32 (operands may be
                # INVALID on pad rows; those rows are masked by rv)
                ox = torch.div(x, st[0], rounding_mode="floor") - ax_off_x
                oy = torch.div(y, st[1], rounding_mode="floor") - ax_off_y
                oz = torch.div(z, st[2], rounding_mode="floor") - ax_off_z
                kx = x - ox * st[0]
                ky = y - oy * st[1]
                kz = z - oz * st[2]
                okx = (kx < ksz[0]) & (ox >= 0)
                oky = (ky < ksz[1]) & (oy >= 0)
                okz = (kz < ksz[2]) & (oz >= 0)
                cand_coords.append(torch.stack([ox, oy, oz, b], dim=-1))
                cand_valid.append(okx & oky & okz & rv)
                cand_koff.append((kx * ksz[1] + ky) * ksz[2] + kz)
    coords_all = torch.cat(cand_coords, 0)
    valid_all = torch.cat(cand_valid, 0)
    koff_all = torch.cat(cand_koff, 0)
    n_rep = len(cand_coords)

    empty = torch.zeros((coords_all.shape[0], 0), dtype=table.feats.dtype,
                        device=dev)
    out_table, row_map = build_sparse_tensor(
        coords_all, empty, valid_all, out_size, table.batch_size, capacity,
        reduce="sum", return_row_map=True)

    src_row = torch.arange(v_in, dtype=torch.int32, device=dev).repeat(n_rep)
    ok = valid_all & (row_map < capacity)
    koff = torch.where(ok, koff_all, kvol).to(torch.int64)

    # conv rulebook: idx[k, out_row] = input row (or v_in when absent);
    # each (k, out_row) has at most one input, so the scatter never
    # collides outside the dropped sentinel slot
    flat_c = torch.where(ok, koff * capacity + row_map, kvol * capacity)
    conv_rb = torch.full((kvol * capacity + 1,), v_in, dtype=torch.int32,
                         device=dev)
    conv_rb[flat_c] = src_row
    conv_rb = conv_rb[:kvol * capacity].reshape(kvol, capacity)

    # deconv rulebook: didx[k, in_row] = out row (or capacity)
    flat_d = torch.where(ok, koff * v_in + src_row, kvol * v_in)
    deconv_rb = torch.full((kvol * v_in + 1,), capacity, dtype=torch.int32,
                           device=dev)
    deconv_rb[flat_d] = row_map
    deconv_rb = deconv_rb[:kvol * v_in].reshape(kvol, v_in)
    return out_table, conv_rb, deconv_rb
