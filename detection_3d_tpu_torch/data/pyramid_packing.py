"""Host-side pyramid construction: every table and rulebook off the card.

Counterpart of detection_3d_tpu/data/pyramid_packing.py. The reference
builds its sparse-conv metadata (per-scale voxel tables, submanifold,
strided, deconv and BEV rulebooks) on the host inside the forward; here
the serving loader builds it for building N+1 while the card runs
building N (engine/inference.run_inference(pipelined=True)).

:func:`pack_pyramid` gives a flat dict of numpy arrays: the
:func:`data.packing.pack_table` fields, each scale's table (u16 coords
and a count) and, for every book of models/backbone.build_pyramid,

  * ``{prefix}_idx`` (K, V_out) int32, the book itself;
  * ``{prefix}_perm`` (V_out,) int32 and ``{prefix}_masks`` (V_out,):
    the book's row order (ops/sparse_conv.RowOrder), which kernel A
    reads. A row's mask has bit k set when the row is valid and
    ``idx[k, i]`` is a real input row; ``perm`` is the stable sort of
    the masks, and ``masks`` holds them in that order, in the narrowest
    unsigned type that holds K bits (:func:`mask_dtype`).

With ``backward=True`` (a pack for a training step) it adds what the
backward books (ops/sparse_conv.BackwardBook) need and cannot read off
the books above (models/backbone.build_pyramid):

  * ``{prefix}_entries`` (nnz, 2) int32 and ``{prefix}_starts`` (K + 1,)
    int32 of every submanifold, downsample (conv side) and BEV book: the
    real entries as (input row, output row) pairs, k-major and
    row-ascending within an offset, as ``np.nonzero`` and
    ``torch.nonzero`` give them. A submanifold book is its own transpose
    (read reversed); a downsample's deconv book is its conv book's
    transpose, and the deconv side's entries are the conv side's with
    the columns swapped;
  * ``bev{slot}_t_idx`` (Z, V_in) int32, the transposed BEV book, with
    its row order ``bev{slot}_t_perm`` / ``bev{slot}_t_masks``.

:func:`unpack_pyramid` rebuilds build_pyramid's dict (its Books in level
order) on the device by elementwise work and casts only: no sort, no
scatter, no search, no ``nonzero``. Every table, book, row order and
backward book is bit equal
to build_pyramid's on :func:`data.packing.unpack_table`'s table
(tests/test_torch_pyramid_packing.py, tests/test_torch_packed_training.py).

The JAX package's windowed relayout fields (``_starts``, ``_local``,
``_hi``) are its TPU kernel's layout; kernel A here reads the row order
instead, so they are not shipped.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from detection_3d_tpu_torch.data.packing import (
    device_table, pack_table, unpack_table,
)
from detection_3d_tpu_torch.ops.sparse_conv import BackwardBook, Book, RowOrder

_NP_INVALID = np.int32(np.iinfo(np.int32).max)


def _np_key(vox, spatial):
    """(n, 3) int voxels (batch 0) -> int64 sort key == device (hi, lo)
    lexicographic order (ops/coords.pack_key: hi = x, lo = y*Z + z)."""
    X, Y, Z = spatial
    return (vox[:, 0].astype(np.int64) * Y + vox[:, 1]) * Z + vox[:, 2]


def _np_dedup(cand_vox, cand_valid, spatial, capacity):
    """Mirror of ops/sparse.build_sparse_tensor (coords only) with
    return_row_map: sorted dedup + unbiased strided overflow keep.

    Returns (vox_out (cap,3) i32, num, true_num, row_map (m,) i32)."""
    m = cand_vox.shape[0]
    key = np.where(cand_valid, _np_key(cand_vox, spatial),
                   np.iinfo(np.int64).max)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    valid_s = cand_valid[order]

    is_first = np.ones(m, bool)
    if m > 1:
        is_first[1:] = key_s[1:] != key_s[:-1]
    seg_id = np.cumsum(is_first) - 1
    num_vox = int((is_first & valid_s).sum())
    stride = max(-(-num_vox // capacity), 1)
    keep = (seg_id % stride) == 0
    slot = seg_id // stride
    num = min(-(-num_vox // stride), capacity)

    row_on = valid_s & keep & (slot < num)
    vox_out = np.full((capacity, 3), _NP_INVALID, np.int32)
    if row_on.any():
        # first occurrence per slot (all rows of a segment share coords)
        sel = np.flatnonzero(row_on)
        vox_out[slot[sel][::-1]] = cand_vox[order[sel][::-1]]

    slot_sorted = np.where(row_on, slot, capacity).astype(np.int32)
    row_map = np.empty(m, np.int32)
    row_map[order] = slot_sorted
    return vox_out, num, num_vox, row_map


def np_downsample_with_rulebooks(vox, num, spatial, kernel, stride,
                                 cap_out):
    """Numpy twin of ops/sparse.downsample_with_rulebooks."""
    ksz, st = tuple(kernel), tuple(stride)
    reach = [max(1, -(-k // s)) for k, s in zip(ksz, st)]
    out_size = tuple(-(-d // s) for d, s in zip(spatial, st))
    v_in = vox.shape[0]
    kvol = ksz[0] * ksz[1] * ksz[2]
    rv = np.arange(v_in) < num
    x, y, z = vox[:, 0].astype(np.int64), vox[:, 1], vox[:, 2]

    cand_vox, cand_valid, cand_koff = [], [], []
    for ax in range(reach[0]):
        for ay in range(reach[1]):
            for az in range(reach[2]):
                ox = x // st[0] - ax
                oy = y // st[1] - ay
                oz = z // st[2] - az
                kx = x - ox * st[0]
                ky = y - oy * st[1]
                kz = z - oz * st[2]
                ok = ((kx < ksz[0]) & (ox >= 0) & (ky < ksz[1])
                      & (oy >= 0) & (kz < ksz[2]) & (oz >= 0) & rv)
                cand_vox.append(np.stack([ox, oy, oz], -1))
                cand_valid.append(ok)
                cand_koff.append((kx * ksz[1] + ky) * ksz[2] + kz)
    cand_vox = np.concatenate(cand_vox)
    cand_valid = np.concatenate(cand_valid)
    koff = np.concatenate(cand_koff)
    n_rep = reach[0] * reach[1] * reach[2]

    vox_out, num_out, true_num, row_map = _np_dedup(
        cand_vox, cand_valid, out_size, cap_out)

    src_row = np.tile(np.arange(v_in, dtype=np.int32), n_rep)
    ok = cand_valid & (row_map < cap_out)
    conv_rb = np.full((kvol, cap_out), v_in, np.int32)
    conv_rb[koff[ok], row_map[ok]] = src_row[ok]
    deconv_rb = np.full((kvol, v_in), cap_out, np.int32)
    deconv_rb[koff[ok], src_row[ok]] = row_map[ok]
    return (vox_out, num_out, true_num, out_size), conv_rb, deconv_rb


def np_subm_idx_27(vox, num, spatial):
    """Numpy twin of ops/sparse.neighbor_indices for the 3^3 kernel:
    (27, V) neighbor rows, missing/out-of-grid/invalid == V."""
    v = vox.shape[0]
    X, Y, Z = spatial
    val = vox[:num].astype(np.int64)
    keys = _np_key(val, spatial)
    offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
    idx = np.full((27, v), v, np.int32)
    for k, (dx, dy, dz) in enumerate(offs):
        q = val + np.array([dx, dy, dz], np.int64)
        inb = ((q[:, 0] >= 0) & (q[:, 0] < X) & (q[:, 1] >= 0)
               & (q[:, 1] < Y) & (q[:, 2] >= 0) & (q[:, 2] < Z))
        qk = _np_key(q, spatial)
        pos = np.searchsorted(keys, qk)
        pos_c = np.minimum(pos, max(num - 1, 0))
        found = inb & (pos < num) & (keys[pos_c] == qk)
        idx[k, :num] = np.where(found, pos_c, v)
    return idx


def np_bev_with_rulebook(vox, num, spatial, capacity):
    """Numpy twin of models/backbone.bev_with_rulebook. The parent table
    is (x, y, z)-sorted, so the z=0 projection is already sorted with
    duplicates consecutive — no sort needed."""
    v_in = vox.shape[0]
    X, Y, Z = spatial
    rv = np.arange(v_in) < num
    kb = vox[:, 0].astype(np.int64) * Y + vox[:, 1]
    kb = np.where(rv, kb, np.iinfo(np.int64).max)
    is_first = np.ones(v_in, bool)
    if v_in > 1:
        is_first[1:] = kb[1:] != kb[:-1]
    seg_id = np.cumsum(is_first) - 1
    num_vox = int((is_first & rv).sum())
    stride = max(-(-num_vox // capacity), 1)
    keep = (seg_id % stride) == 0
    slot = seg_id // stride
    num_bev = min(-(-num_vox // stride), capacity)
    row_on = rv & keep & (slot < num_bev)

    bev_vox = np.full((capacity, 3), _NP_INVALID, np.int32)
    sel = np.flatnonzero(row_on)
    bev_vox[slot[sel][::-1], 0] = vox[sel[::-1], 0]
    bev_vox[slot[sel][::-1], 1] = vox[sel[::-1], 1]
    bev_vox[slot[sel][::-1], 2] = 0

    rb = np.full((Z, capacity), v_in, np.int32)
    rb[vox[sel, 2], slot[sel]] = sel.astype(np.int32)
    return bev_vox, num_bev, rb


def mask_dtype(k: int) -> np.dtype:
    """The narrowest unsigned type that holds a K-offset row mask (int64,
    as ops/sparse_conv.row_masks keeps it, above 32 offsets)."""
    for bits, dt in ((8, np.uint8), (16, np.uint16), (32, np.uint32)):
        if k <= bits:
            return np.dtype(dt)
    return np.dtype(np.int64)


def np_row_order(idx, num_out, v_in):
    """Numpy twin of ops/sparse_conv.rulebook_row_order for a book whose
    valid output rows are its first ``num_out``: (perm (V_out,) int32,
    the masks in perm's order as :func:`mask_dtype`)."""
    k, v_out = idx.shape
    if k > 64:
        raise ValueError(f"row masks take at most 64 offsets, got {k}")
    real = (idx >= 0) & (idx < v_in) & (np.arange(v_out) < num_out)[None]
    masks = np.zeros(v_out, np.int64)
    for j in range(k):
        masks |= real[j].astype(np.int64) << j
    perm = np.argsort(masks, kind="stable").astype(np.int32)
    return perm, masks[perm].astype(mask_dtype(k))


def np_entries(idx, num_out, v_in):
    """Numpy twin of ops/sparse_conv.rulebook_entries for a book whose
    valid output rows are its first ``num_out``: (entries (nnz, 2) int32
    of (input row, output row), k-major and row-ascending; starts (K + 1,)
    int32)."""
    k, v_out = idx.shape
    real = (idx >= 0) & (idx < v_in) & (np.arange(v_out) < num_out)[None]
    kk, ii = np.nonzero(real)
    entries = np.stack([idx[kk, ii], ii], 1).astype(np.int32)
    starts = np.zeros(k + 1, np.int32)
    starts[1:] = np.cumsum(real.sum(1))
    return entries, starts


def np_transpose(idx, num_out, v_in):
    """Numpy twin of ops/sparse_conv.transpose_rulebook's book: (K, V_in)
    int32 with ``t[k, idx[k, i]] = i`` for each real entry, V_out
    elsewhere. Raises ValueError when two real entries of one offset read
    the same input row."""
    k, v_out = idx.shape
    real = (idx >= 0) & (idx < v_in) & (np.arange(v_out) < num_out)[None]
    kk, ii = np.nonzero(real)
    t = np.full((k, v_in), v_out, np.int32)
    t[kk, idx[kk, ii]] = ii
    if (t[kk, idx[kk, ii]] != ii).any():
        raise ValueError("np_transpose: two entries of one offset read the "
                         "same input row")
    return t


def _scale_dims(s3d):
    """Each scale's (X, Y, Z) grid."""
    dims = [tuple(s3d.voxel_full_scale)]
    for st in s3d.strides[:s3d.num_scales - 1]:
        dims.append(tuple(-(-d // s) for d, s in zip(dims[-1], st)))
    return dims


def _bev_scales(cfg):
    """{BEV slot: the 3D scale it collapses}."""
    n = cfg.sparse3d.num_scales
    return {slot: n - 1 - i
            for slot, i in enumerate(cfg.rpn.rpn_scales_from_top)}


def pyramid_pack_spec(cfg, backward: bool = False
                      ) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
    """{name: (shape, dtype)} of every array :func:`pack_pyramid` adds to
    the :func:`pack_table` fields for this config (the native packer's
    output buffers, data/native_packer.py). With ``backward``, each
    ``_entries`` array is sized to the most entries its book can hold;
    the pack holds the first ``_starts[-1]`` of them."""
    s3d = cfg.sparse3d
    n_scales = s3d.num_scales
    caps = cfg.caps.scale_caps(n_scales)
    dims = _scale_dims(s3d)
    i32 = np.dtype(np.int32)
    spec: Dict[str, Tuple[Tuple[int, ...], np.dtype]] = {}

    def book(prefix, kvol, v_out):
        spec[f"{prefix}_idx"] = ((kvol, v_out), i32)
        spec[f"{prefix}_perm"] = ((v_out,), i32)
        spec[f"{prefix}_masks"] = ((v_out,), mask_dtype(kvol))

    def entries(prefix, kvol, most):
        if backward:
            spec[f"{prefix}_entries"] = ((most, 2), i32)
            spec[f"{prefix}_starts"] = ((kvol + 1,), i32)

    for k in range(1, n_scales):
        ks, st = s3d.kernels[k - 1], s3d.strides[k - 1]
        kvol = ks[0] * ks[1] * ks[2]
        reach = int(np.prod([max(1, -(-a // b)) for a, b in zip(ks, st)]))
        spec[f"t{k}_vox"] = ((caps[k], 3), np.dtype(np.uint16))
        spec[f"t{k}_num"] = ((), i32)
        book(f"down{k - 1}", kvol, caps[k])
        # an input row feeds at most `reach` output rows, one offset each
        entries(f"down{k - 1}", kvol, min(kvol * caps[k],
                                          reach * caps[k - 1]))
        book(f"up{k - 1}", kvol, caps[k - 1])
    for k in range(n_scales):
        book(f"subm{k}", 27, caps[k])
        entries(f"subm{k}", 27, 27 * caps[k])
    for slot, scale in _bev_scales(cfg).items():
        z = dims[scale][2]
        spec[f"bev{slot}_vox"] = ((caps[scale], 3), np.dtype(np.uint16))
        spec[f"bev{slot}_num"] = ((), i32)
        book(f"bev{slot}", z, caps[scale])
        # every 3D row lies in at most one BEV entry
        entries(f"bev{slot}", z, caps[scale])
        if backward:
            book(f"bev{slot}_t", z, caps[scale])
            spec[f"bev{slot}_t_idx"] = ((z, caps[scale]), i32)
    return spec


def _book_entries(prefix, idx, num_out, v_in):
    perm, masks = np_row_order(idx, num_out, v_in)
    return {f"{prefix}_idx": idx.astype(np.int32), f"{prefix}_perm": perm,
            f"{prefix}_masks": masks}


def _entry_lists(prefix, idx, num_out, v_in):
    entries, starts = np_entries(idx, num_out, v_in)
    return {f"{prefix}_entries": entries, f"{prefix}_starts": starts}


def _u16_table(vox, num):
    """Valid rows' coords as u16 (pad rows read INVALID on the device,
    which re-marks them by ``num``; u16 cannot hold it)."""
    return np.where(np.arange(vox.shape[0])[:, None] < num, vox,
                    0).astype(np.uint16)


def pack_pyramid(cfg, scene: Dict,
                 backward: bool = False) -> Dict[str, np.ndarray]:
    """Host: the quantized scale-0 table and every pyramid table, book
    and row order, and with ``backward`` the backward books' entry lists
    and BEV transposes. Flat dict of numpy arrays, :func:`pack_table`'s
    fields included; :func:`unpack_pyramid` is the consumer."""
    out = dict(pack_table(cfg, scene))
    s3d = cfg.sparse3d
    n_scales = s3d.num_scales
    caps = cfg.caps.scale_caps(n_scales)

    vox = out["vox"].astype(np.int32)
    num = int(out["num"])
    tables = [(vox, num, tuple(s3d.voxel_full_scale))]
    for k in range(1, n_scales):
        vin, nin, sp = tables[-1]
        (vox_o, num_o, _true, out_size), crb, drb = \
            np_downsample_with_rulebooks(vin, nin, sp, s3d.kernels[k - 1],
                                         s3d.strides[k - 1], caps[k])
        out[f"t{k}_vox"] = _u16_table(vox_o, num_o)
        out[f"t{k}_num"] = np.int32(num_o)
        out.update(_book_entries(f"down{k - 1}", crb, num_o, caps[k - 1]))
        out.update(_book_entries(f"up{k - 1}", drb, nin, caps[k]))
        if backward:
            out.update(_entry_lists(f"down{k - 1}", crb, num_o,
                                    caps[k - 1]))
        tables.append((vox_o, num_o, out_size))

    for k, (vx, nm, sp) in enumerate(tables):
        idx = np_subm_idx_27(vx, nm, sp)
        out.update(_book_entries(f"subm{k}", idx, nm, vx.shape[0]))
        if backward:
            out.update(_entry_lists(f"subm{k}", idx, nm, vx.shape[0]))

    for slot, scale in _bev_scales(cfg).items():
        vx, nm, sp = tables[scale]
        v_in = vx.shape[0]
        bev_vox, bev_num, brb = np_bev_with_rulebook(vx, nm, sp, v_in)
        out[f"bev{slot}_vox"] = _u16_table(bev_vox, bev_num)
        out[f"bev{slot}_num"] = np.int32(bev_num)
        out.update(_book_entries(f"bev{slot}", brb, bev_num, v_in))
        if backward:
            out.update(_entry_lists(f"bev{slot}", brb, bev_num, v_in))
            # the transpose's rows are the 3D rows, every one wanted
            out.update(_book_entries(f"bev{slot}_t",
                                     np_transpose(brb, bev_num, v_in),
                                     v_in, brb.shape[1]))
    return out


def _row_order(packed, prefix) -> RowOrder:
    """A book's RowOrder from its shipped perm and narrow masks; a
    stacked dict's B orders laid end to end over the flat rows (each
    building's rows stay grouped by mask, and kernel A's result does not
    depend on the order)."""
    perm = packed[f"{prefix}_perm"]
    masks = packed[f"{prefix}_masks"].to(torch.int64)
    if perm.dim() == 1:
        return RowOrder(perm, masks)
    nb, v = perm.shape
    base = torch.arange(nb, device=perm.device)[:, None] * v
    return RowOrder((perm + base).to(torch.int32).reshape(-1),
                    masks.reshape(-1))


def _book(packed, prefix, v_in: int):
    """A shipped book; a stacked dict's (B, K, V_out) books, each over
    its own v_in rows, as the unit's flat (K, B * V_out) book over B *
    v_in rows (entries ``idx + b * v_in``, pad ``B * v_in``)."""
    idx = packed[f"{prefix}_idx"]
    if idx.dim() == 2:
        return idx
    nb, k, v_out = idx.shape
    base = torch.arange(nb, device=idx.device)[:, None, None] * v_in
    flat = torch.where(idx < v_in, idx + base, nb * v_in)
    return flat.to(torch.int32).transpose(0, 1).reshape(k, nb * v_out)


def _with_backward_books(packed, pyr):
    """``pyr``'s Books with their backward books, from a ``backward``
    pack and the forward books: submanifold books read reversed, each
    downsample's conv and deconv books as each other's transposes (the
    deconv side's entries column-swapped), the BEV books' shipped
    transposes."""
    def lists(prefix):
        return packed[f"{prefix}_entries"], packed[f"{prefix}_starts"]

    pyr["subm"] = [b._replace(bwd=BackwardBook(b.idx, b.order,
                                               *lists(f"subm{k}"),
                                               reversed=True))
                   for k, b in enumerate(pyr["subm"])]
    down, up = pyr["down"], pyr["up"]
    for k in range(len(down)):
        entries, starts = lists(f"down{k}")
        down[k], up[k] = (
            down[k]._replace(bwd=BackwardBook(up[k].idx, up[k].order,
                                              entries, starts)),
            up[k]._replace(bwd=BackwardBook(down[k].idx, down[k].order,
                                            entries.flip(1), starts)))
    for slot, (t, b) in pyr["bev"].items():
        pyr["bev"][slot] = (t, b._replace(bwd=BackwardBook(
            packed[f"bev{slot}_t_idx"], _row_order(packed, f"bev{slot}_t"),
            *lists(f"bev{slot}"))))
    return pyr


def unpack_pyramid(cfg, packed, backward: bool = False) -> Dict:
    """Device side: a :func:`pack_pyramid` dict (tensors) -> the dict of
    models/backbone.build_pyramid (tables, and the Books subm, down, up
    in level order and bev; with ``backward``, from a ``backward`` pack,
    every Book with its backward book). ``tables[0]`` is
    :func:`data.packing.unpack_table`'s table, ``true_num`` included.
    Elementwise work and casts only. A dict stacked over B buildings
    gives a unit's pyramid: stacked tables and flat books (ops/sparse.py)
    whose row orders are the buildings' own, laid end to end; its
    backward books are not unpacked (a unit is served, not trained)."""
    n_scales = cfg.sparse3d.num_scales
    dims = _scale_dims(cfg.sparse3d)
    tables = [unpack_table(cfg, packed)]
    tables += [device_table(packed[f"t{k}_vox"], packed[f"t{k}_num"],
                            dims[k]) for k in range(1, n_scales)]
    if backward and tables[0].batched:
        raise ValueError("unpack_pyramid: the backward books of a stacked "
                         "dict are not unpacked")
    cap = [t.capacity for t in tables]

    def book(prefix, v_in):
        return Book(_book(packed, prefix, v_in), _row_order(packed, prefix))

    bev = {}
    for slot, scale in _bev_scales(cfg).items():
        X, Y, _ = dims[scale]
        bev[slot] = (device_table(packed[f"bev{slot}_vox"],
                                  packed[f"bev{slot}_num"], (X, Y, 1)),
                     book(f"bev{slot}", cap[scale]))
    pyr = {"tables": tables,
           "subm": [book(f"subm{k}", cap[k]) for k in range(n_scales)],
           "down": [book(f"down{k}", cap[k]) for k in range(n_scales - 1)],
           "up": [book(f"up{k}", cap[k + 1]) for k in range(n_scales - 1)],
           "bev": bev}
    return _with_backward_books(packed, pyr) if backward else pyr
