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

V is a static capacity and every op masks with ``row_valid``.

A unit of B buildings served by one forward (engine/inference.
make_batch_predict_fn, the port of the JAX package's ``jax.vmap``) stacks
B tables: coords (B, V, 4), feats (B, V, C), keys (B, V), num and
true_num (B,). Building b keeps what it has alone: its capacity V, its
overflow stride, its ``num`` and ``true_num``, and no op searches or
gathers its rows for another building. The table-building ops (sorts,
cumsums, searches) run on that stacked form, building by building along
the last axis; row-wise kernels run on the flat view of B * V rows, in
which building b owns rows [b * V, (b + 1) * V). A rulebook of a unit is
flat: its entries are global rows (``idx + b * V_in``) and its pad entry
is B * V_in, the flat input's one zero row. Each op takes one building's
table as the B = 1 case and gives one building's results for it. The JAX
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
reference. B's 5x5x5 form (:func:`neighbor_match` at radius 2, a
segmentation network's 5^3 stem) searches the 25 columns of a 5 x 5
window the same way, each for its five dz neighbours among five
consecutive rows, and writes the 125-offset book and its two-word row
masks in one launch.
"""

from __future__ import annotations

from typing import Tuple

import torch

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.coords import (
    INVALID, composite_key, key_search, pack_key,
)


class SparseTensor:
    """Sorted sparse voxel table of one building, or the stacked tables
    of a unit of buildings (see the module docstring)."""

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
    def batched(self) -> bool:
        """True for the stacked tables of a unit, (B, V, ...)."""
        return self.coords.dim() == 3

    @property
    def units(self) -> int:
        """Buildings held: B when stacked, else 1."""
        return self.coords.shape[0] if self.batched else 1

    @property
    def capacity(self) -> int:
        """Rows of each building's table."""
        return self.coords.shape[-2]

    @property
    def rows(self) -> int:
        """Rows of the flat view, B * V."""
        return self.units * self.capacity

    @property
    def num_channels(self) -> int:
        return self.feats.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.coords.device

    @property
    def row_valid(self):
        """(V,) or (B, V) bool: the active rows of each building."""
        return torch.arange(self.capacity, device=self.device) < \
            self.num[..., None]

    def with_feats(self, feats) -> "SparseTensor":
        return SparseTensor(self.coords, feats, self.hi, self.lo, self.num,
                            self.spatial_size, self.batch_size,
                            self.true_num, self.keys)

    def stacked(self) -> "SparseTensor":
        """This table as a unit: itself when stacked, else a unit of one."""
        if self.batched:
            return self
        return SparseTensor(self.coords[None], self.feats[None],
                            self.hi[None], self.lo[None],
                            self.num.reshape(1), self.spatial_size,
                            self.batch_size, self.true_num.reshape(1),
                            self.keys[None])

    def building(self, b: int) -> "SparseTensor":
        """Building b of a unit as one building's table."""
        return SparseTensor(self.coords[b], self.feats[b], self.hi[b],
                            self.lo[b], self.num[b], self.spatial_size,
                            self.batch_size, self.true_num[b], self.keys[b])

    def lookup(self, coords, valid=None):
        """Find rows for query coords (..., 4), each building's in its own
        table (a unit's queries lead with B). Returns (idx, found), idx
        the row within the building's table."""
        qhi, qlo = pack_key(coords, self.spatial_size, valid)
        return key_search(self.keys, qhi, qlo)


def _like(table: SparseTensor, one: bool) -> SparseTensor:
    """A unit result as one building's table when ``one``."""
    return table.building(0) if one else table


def build_sparse_tensor(coords, feats, valid, spatial_size, batch_size,
                        capacity: int, reduce: str = "mean",
                        return_row_map: bool = False):
    """Deduplicating input layer: raw voxel coords -> SparseTensor.

    Rows with equal (x, y, z, b) merge; ``reduce`` 'mean' averages their
    features ('sum' adds them, 'max' takes their elementwise maximum). Out-of-grid and ``~valid`` rows are
    dropped. When more voxels than ``capacity`` exist, every k-th voxel
    (k = ceil(num / capacity)) is kept so coverage stays spatially
    uniform, and ``true_num`` keeps the pre-truncation count.

    Args:
      coords: (N, 4) int32 [x, y, z, b]; feats: (N, C); valid: (N,) bool
        or None; capacity: static output table size. Stacked inputs
        (B, N, 4), (B, N, C), (B, N) build the B tables of a unit, each
        as it would be built alone (its own stride, num and true_num);
      return_row_map: also return (N,) int32 — for every INPUT row, the
        output row holding its voxel (== capacity when the row was invalid
        or its voxel was dropped by the overflow stride); (B, N) rows of
        each building's own table for stacked inputs.
    """
    if reduce not in ("mean", "sum", "max"):
        raise ValueError(
            f"reduce={reduce!r}: expected 'mean', 'sum' or 'max'")
    one = coords.dim() == 2
    if one:
        coords, feats = coords[None], feats[None]
        valid = None if valid is None else valid[None]
    nb, n = coords.shape[:2]
    c = feats.shape[-1]
    dev = coords.device
    if valid is None:
        valid = torch.ones((nb, n), dtype=torch.bool, device=dev)
    hi, lo = pack_key(coords, spatial_size, valid)
    keys, order = torch.sort(composite_key(hi, lo), dim=-1, stable=True)
    hi, lo = hi.gather(1, order), lo.gather(1, order)
    coords_s = coords.gather(1, order[..., None].expand(nb, n, 4))
    feats_s = feats.gather(1, order[..., None].expand(nb, n, c))

    is_first = torch.ones((nb, n), dtype=torch.bool, device=dev)
    is_first[:, 1:] = keys[:, 1:] != keys[:, :-1]
    seg_id = torch.cumsum(is_first.to(torch.int32), 1,
                          dtype=torch.int32) - 1
    key_ok = hi != INVALID
    num_vox = (is_first & key_ok).sum(1, dtype=torch.int32)

    # capacity overflow: keep every stride-th segment (see docstring)
    stride = torch.clamp(torch.div(num_vox + capacity - 1, capacity,
                                   rounding_mode="floor"), min=1)
    keep = torch.remainder(seg_id, stride[:, None]) == 0
    slot = torch.div(seg_id, stride[:, None], rounding_mode="floor")
    row_on = key_ok & keep
    # each building's slots in its own block of the flat output
    seg_c = (torch.clamp(slot, max=capacity - 1).to(torch.int64)
             + torch.arange(nb, device=dev)[:, None] * capacity).reshape(-1)
    flat_on = row_on.reshape(-1)
    feats_f = feats_s.reshape(nb * n, c)

    size = nb * capacity
    out_feats = torch.zeros((size, c), dtype=feats.dtype, device=dev)
    if c and reduce == "max":
        # rows off the table take the dtype's lowest value; a slot no row
        # reaches stays -inf, and non-finite results become 0
        lowest = torch.finfo(feats.dtype).min
        out_feats = torch.full((size, c), -torch.inf, dtype=feats.dtype,
                               device=dev)
        out_feats.scatter_reduce_(
            0, seg_c[:, None].expand(nb * n, c),
            torch.where(flat_on[:, None], feats_f, lowest), reduce="amax")
        out_feats = torch.where(torch.isfinite(out_feats), out_feats, 0.0)
    elif c:
        ones = flat_on.to(feats.dtype)
        out_feats.index_add_(0, seg_c, feats_f * ones[:, None])
        if reduce == "mean":
            counts = torch.zeros((size,), dtype=feats.dtype, device=dev)
            counts.index_add_(0, seg_c, ones)
            out_feats = out_feats / torch.clamp(counts, min=1.0)[:, None]
    out_feats = out_feats.reshape(nb, capacity, c)

    # representative coords/keys per segment (first occurrence)
    rows = torch.arange(n, device=dev).expand(nb, n)
    first_idx = torch.full((size,), n, dtype=torch.int64, device=dev)
    first_idx.scatter_reduce_(0, seg_c,
                              torch.where(row_on, rows, n).reshape(-1),
                              reduce="amin")
    first_idx = first_idx.reshape(nb, capacity)
    in_range = first_idx < n
    gather_idx = torch.clamp(first_idx, max=n - 1)

    num = torch.clamp(torch.div(num_vox + stride - 1, stride,
                                rounding_mode="floor"), max=capacity)
    row_ok = torch.arange(capacity, device=dev) < num[:, None]
    ok = in_range & row_ok
    out_coords = torch.where(
        ok[..., None],
        coords_s.gather(1, gather_idx[..., None].expand(nb, capacity, 4)),
        INVALID)
    out_hi = torch.where(ok, hi.gather(1, gather_idx), INVALID)
    out_lo = torch.where(ok, lo.gather(1, gather_idx), INVALID)
    out_feats = torch.where(row_ok[..., None], out_feats, 0.0)
    table = _like(SparseTensor(out_coords, out_feats, out_hi, out_lo, num,
                               spatial_size, batch_size, true_num=num_vox),
                  one)
    if not return_row_map:
        return table
    slot_sorted = torch.where(row_on & (slot < num[:, None]), slot, capacity)
    row_map = torch.empty_like(slot_sorted).scatter_(1, order, slot_sorted)
    return table, (row_map[0] if one else row_map)


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


def neighbor_match_columns(table: SparseTensor, radius: int = 1):
    """Kernel B's algorithm in plain PyTorch: (rulebook, row masks) of the
    (2r+1)^3 submanifold offsets, r = ``radius`` (1 or 2), the book equal
    bit for bit to :func:`neighbor_indices` over
    ``submanifold_offsets((2r+1,) * 3)`` and bit k of mask i set where
    ``idx[k, i] < V`` (ops/sparse_conv.row_masks of the book: (V,) int64
    for 27 offsets, (V, 2) for 125). A unit's book is flat, ((2r+1)^3, B
    * V) with the pad B * V, and its masks (B * V, ...): each building
    searched in its own table.

    Per column (dx, dy), one lower-bound search for the key t of (x+dx,
    y+dy, z-r) gives row p; the neighbour at dz is the row among p ..
    p+2r whose key is t + r + dz. For r = 1 the centre column is the site
    (dz = 0) and the rows before and after it where their keys are the
    site's key -1 / +1; for r = 2 it is searched like the others.
    Out-of-grid columns, and dz with z + dz outside [0, Z), are masked
    from the coords: a shifted key there is another voxel's key."""
    t = table.stacked()
    nb, v = t.units, t.capacity
    X, Y, Z = t.spatial_size
    dev = t.device
    keys = t.keys
    x, y, z, b = t.coords.to(torch.int64).unbind(-1)
    rv = t.row_valid & (b >= 0)
    key = ((b * X + x) << 32) | (y * Z + z)
    rows = torch.arange(v, device=dev)
    side = 2 * radius + 1
    n_off = side ** 3
    z_ok = [(z + dz >= 0) & (z + dz < Z) for dz in range(-radius, radius + 1)]
    out = torch.full((n_off, nb, v), v, dtype=torch.int64, device=dev)
    words = 1 if n_off <= 64 else 2
    masks = torch.zeros((words, nb, v), dtype=torch.int64, device=dev)
    for dx in range(-radius, radius + 1):
        for dy in range(-radius, radius + 1):
            k0 = side * side * (dx + radius) + side * (dy + radius)
            col_ok = (rv & (x + dx >= 0) & (x + dx < X) & (y + dy >= 0)
                      & (y + dy < Y))
            if dx == 0 and dy == 0 and radius == 1:
                near = (torch.cat([keys[:, :1] - 2, keys[:, :-1]], 1)
                        == key - 1,
                        torch.ones_like(rv),
                        torch.cat([keys[:, 1:], keys[:, -1:] + 2], 1)
                        == key + 1)
                cand = (rows - 1, rows, rows + 1)
                pos = [torch.where(near[dz], cand[dz], v) for dz in range(3)]
            else:
                q = key + (dx << 32) + dy * Z - radius
                p = torch.searchsorted(keys, q)
                pos = [torch.full_like(p, v) for _ in range(side)]
                for j in range(side):
                    inside = p + j < v
                    kj = keys.gather(1, (p + j).clamp(max=v - 1))
                    for dz in range(j, side):  # keys rise: q + dz at <= p + dz
                        pos[dz] = torch.where(inside & (kj == q + dz), p + j,
                                              pos[dz])
            for dz in range(side):
                k = k0 + dz
                idx = torch.where(col_ok & z_ok[dz], pos[dz], v)
                out[k] = idx
                masks[k // 64] |= (idx < v).to(torch.int64) << (k % 64)
    # building b's rows are flat rows b * V ..; the pad is B * V
    base = torch.arange(nb, device=dev)[:, None] * v
    book = torch.where(out < v, out + base, nb * v)
    masks = masks.reshape(words, nb * v)
    return (book.to(torch.int32).reshape(n_off, nb * v),
            masks[0] if words == 1 else masks.T.contiguous())


# kernel B's windows: rows of each of a block's three shared-memory
# windows, and the table size from which they are used (below it the
# kernel searches the whole table, which sits in L1/L2)
SUBM_WINDOW = 1024
SUBM_WINDOW_MIN_ROWS = 65536


def subm_match_cuda(table: SparseTensor, window: int = None,
                    radius: int = 1):
    """Kernel B on the card: the contract of :func:`neighbor_match_columns`
    at ``radius`` 1 (27 offsets, entry ``subm_match_3x3x3``) or 2 (125,
    ``subm_match_5x5x5``), a unit's B tables in one launch (block (tile,
    b) searches table b and writes global rows). For radius 1,
    ``window`` >= 1 is the rows of each of a block's three shared-memory
    windows (3 * 8 * window bytes; a longer window is searched in global
    memory between its ends, with the same answers); 0 searches the
    whole table, 8 threads a site. None: SUBM_WINDOW from
    SUBM_WINDOW_MIN_ROWS rows, else 0. Radius 2 takes no window."""
    t = table.stacked()
    nb, v = t.units, t.capacity
    if window is None:
        window = SUBM_WINDOW if v >= SUBM_WINDOW_MIN_ROWS and radius == 1 \
            else 0
    n_off = (2 * radius + 1) ** 3
    X, Y, Z = t.spatial_size
    coords, keys, num = t.coords, t.keys, t.num
    if not (radius in (1, 2) and (radius == 1 or window == 0)
            and coords.dtype == torch.int32 and coords.shape == (nb, v, 4)
            and keys.dtype == torch.int64 and keys.shape == (nb, v)
            and num.dtype == torch.int32 and num.shape == (nb,)
            and coords.is_contiguous() and keys.is_contiguous()
            and num.is_contiguous() and keys.device == coords.device
            and num.device == coords.device and coords.is_cuda
            and 0 <= window and 3 * 8 * window <= cuda_lib.SHARED_BYTES
            and nb <= 65535 and n_off * nb * v < 2 ** 31):
        raise ValueError("subm_match_cuda: expected radius 1 or 2 (a window "
                         "at radius 1 only), contiguous int32 coords (B, V, "
                         "4), int64 keys (B, V) and int32 num (B,) on one "
                         "card, at most 65535 tables, a book under 2^31 "
                         "entries, and three windows that fit shared memory")
    dev = coords.device
    out = torch.empty((n_off, nb * v), dtype=torch.int32, device=dev)
    masks = torch.empty((nb * v,) if radius == 1 else (nb * v, 2),
                        dtype=torch.int64, device=dev)
    lib = cuda_lib.library("subm_match")
    head = (keys.data_ptr(), coords.data_ptr(), num.data_ptr(), nb, v, X, Y,
            Z)
    tail = (out.data_ptr(), masks.data_ptr(), cuda_lib.stream_ptr(dev))
    if radius == 1:
        status = lib.subm_match_3x3x3(*head, window, *tail)
    else:
        status = lib.subm_match_5x5x5(*head, *tail)
    cuda_lib.check("subm_match", status)
    cuda_lib.launches["subm_match"] += 1
    return out, masks


def neighbor_match(table: SparseTensor, radius: int = 1):
    """(((2r+1)^3, V) submanifold rulebook, its row masks: (V,) int64 for
    radius 1, (V, 2) for radius 2; a unit's flat ((2r+1)^3, B * V) and (B
    * V, ...)): kernel B on the card, the plain
    :func:`neighbor_match_columns` on the CPU. Equal bit for bit."""
    if table.coords.is_cuda:
        return subm_match_cuda(table, radius=radius)
    return neighbor_match_columns(table, radius)


def neighbor_match_3x3x3(table: SparseTensor):
    """:func:`neighbor_match` at radius 1: the 27-offset book and (V,)
    masks that every 3x3x3 submanifold conv reads."""
    return neighbor_match(table)


def _downsample_candidates(table: SparseTensor, kernel, stride):
    """Every (output site, kernel offset) a strided conv's input rows
    reach: an output site exists iff >= 1 active input lies in its
    receptive field [o*stride, o*stride + kernel) (SCN
    ConvolutionRules.h:11-60); each input at x reaches the outputs
    ceil((x-k+1)/s) .. floor(x/s), prod(ceil(k/s)) candidates a row.

    Returns (coords (n_rep * V_in, 4), valid, kernel offset index, output
    spatial size, n_rep), the candidates of input row i at rows i,
    V_in + i, ...; a unit's lead with B."""
    ksz = tuple(kernel)
    st = tuple(stride)
    reach = [max(1, -(-k // s)) for k, s in zip(ksz, st)]
    out_size = tuple(-(-d // s) for d, s in zip(table.spatial_size, st))
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
    return (torch.cat(cand_coords, -2), torch.cat(cand_valid, -1),
            torch.cat(cand_koff, -1), out_size, len(cand_coords))


def downsample_table(table: SparseTensor, kernel, stride, capacity: int):
    """The strided conv's output table alone (zero-channel features), as
    JAX's ops/sparse.downsample_table builds it: the dedup sort of
    :func:`_downsample_candidates`. The spatial pyramid takes its books
    from kernel D instead of this sort's scatters
    (parallel/spatial.build_spatial_pyramid)."""
    coords_all, valid_all, _, out_size, _ = _downsample_candidates(
        table, kernel, stride)
    empty = torch.zeros(coords_all.shape[:-1] + (0,),
                        dtype=table.feats.dtype, device=table.device)
    return build_sparse_tensor(coords_all, empty, valid_all, out_size,
                               table.batch_size, capacity, reduce="sum")


def downsample_with_rulebooks(table: SparseTensor, kernel, stride,
                              capacity: int):
    """Strided-conv output table + conv AND deconv rulebooks in one pass.

    Every (input row, output site, kernel offset) triple of the strided
    conv is expanded, the dedup sort of :func:`build_sparse_tensor`
    assigns each candidate its output row (``return_row_map``), and both
    rulebooks are single scatters of that mapping.

    Returns (out_table, conv_rb (K, capacity), deconv_rb (K, V_in)),
    int32, with pad entries V_in and capacity respectively. A unit gives
    the stacked output tables and flat books, (K, B * capacity) over the
    B * V_in input rows and (K, B * V_in) over the B * capacity output
    rows.
    """
    ksz = tuple(kernel)
    t = table.stacked()
    nb, v_in = t.units, t.capacity
    kvol = ksz[0] * ksz[1] * ksz[2]
    dev = t.device
    coords_all, valid_all, koff_all, out_size, n_rep = \
        _downsample_candidates(t, kernel, stride)

    empty = torch.zeros(coords_all.shape[:-1] + (0,), dtype=t.feats.dtype,
                        device=dev)
    out_table, row_map = build_sparse_tensor(
        coords_all, empty, valid_all, out_size, t.batch_size, capacity,
        reduce="sum", return_row_map=True)

    unit = torch.arange(nb, device=dev)[:, None]
    src_row = (torch.arange(v_in, device=dev).repeat(n_rep)
               + unit * v_in).to(torch.int32)
    out_row = (row_map + unit * capacity).to(torch.int32)
    ok = valid_all & (row_map < capacity)
    koff = torch.where(ok, koff_all, kvol).to(torch.int64)

    # conv rulebook: idx[k, out_row] = input row (or B * v_in when
    # absent); each (k, out_row) has at most one input, so the scatter
    # never collides outside the dropped sentinel slot
    n_out, n_in = nb * capacity, nb * v_in
    flat_c = torch.where(ok, koff * n_out + out_row, kvol * n_out)
    conv_rb = torch.full((kvol * n_out + 1,), n_in, dtype=torch.int32,
                         device=dev)
    conv_rb[flat_c] = src_row.expand(nb, -1)
    conv_rb = conv_rb[:kvol * n_out].reshape(kvol, n_out)

    # deconv rulebook: didx[k, in_row] = out row (or B * capacity)
    flat_d = torch.where(ok, koff * n_in + src_row, kvol * n_in)
    deconv_rb = torch.full((kvol * n_in + 1,), n_out, dtype=torch.int32,
                           device=dev)
    deconv_rb[flat_d] = out_row
    deconv_rb = deconv_rb[:kvol * n_in].reshape(kvol, n_in)
    return _like(out_table, not table.batched), conv_rb, deconv_rb


def conv_rulebook(out_table: SparseTensor, in_table: SparseTensor, kernel,
                  stride):
    """(K, V_out) strided-conv rulebook by search: entry [k, o] is the
    input row at out_coord(o) * stride + offset_k, V_in where absent (JAX
    ops/sparse.py:522). Kernel D on the card
    (ops/multi_match.conv_rulebook_match); equal to the scatter-derived
    book of :func:`downsample_with_rulebooks`."""
    from detection_3d_tpu_torch.ops.multi_match import conv_rulebook_match
    return conv_rulebook_match(out_table, in_table, kernel, stride)
