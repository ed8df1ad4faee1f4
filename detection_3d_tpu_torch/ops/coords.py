"""Voxel-coordinate keys and sorted-table search.

Counterpart of detection_3d_tpu/ops/coords.py. Active voxel coordinates
are sorted by the lexicographic key pair

    hi = b * X + x          lo = y * Z + z

and padding rows carry hi = lo = INVALID, so they sort last and never
match a query. The port keeps the int32 pair (the JAX package's layout)
and also one int64 composite ``(hi << 32) | lo``: both halves are
non-negative, so the int64 order IS the lexicographic order, and one
``torch.searchsorted`` on it gives the answers of ``lex_searchsorted``.
"""

from __future__ import annotations

import torch

INVALID = 2 ** 31 - 1


def pack_key(coords, spatial_size, valid=None):
    """(..., 4) int32 coords [x, y, z, b] -> (hi, lo) int32 keys.

    Out-of-bounds or invalid coords map to (INVALID, INVALID).
    """
    x, y, z, b = coords.unbind(-1)
    X, Y, Z = spatial_size
    hi = b * X + x
    lo = y * Z + z
    inb = (x >= 0) & (x < X) & (y >= 0) & (y < Y) & (z >= 0) & (z < Z) \
        & (b >= 0)
    if valid is not None:
        inb = inb & valid
    hi = torch.where(inb, hi, INVALID)
    lo = torch.where(inb, lo, INVALID)
    return hi, lo


def composite_key(hi, lo):
    """int64 ``(hi << 32) | lo``: orders like the (hi, lo) pair."""
    return (hi.to(torch.int64) << 32) | lo.to(torch.int64)


def lex_sort(hi, lo, *arrays):
    """Sort rows by (hi, lo) ascending (stable); returns (hi, lo, *arrays)
    sorted."""
    _, order = torch.sort(composite_key(hi, lo), stable=True)
    return tuple(a[order] for a in (hi, lo) + tuple(arrays))


def key_search(keys_sorted, hi_q, lo_q):
    """Find composite-key queries in a sorted int64 key table.

    Returns (idx, found): ``idx`` (...,) int32 is the lower-bound position
    clipped to the table (meaningful only where found), ``found`` is true
    on an exact match of a real (non-INVALID) key.
    """
    q = composite_key(hi_q, lo_q)
    n = keys_sorted.shape[0]
    pos = torch.searchsorted(keys_sorted, q.reshape(-1)).reshape(q.shape)
    idx = pos.clamp(0, n - 1)
    found = (keys_sorted[idx] == q) & (hi_q != INVALID)
    return idx.to(torch.int32), found
