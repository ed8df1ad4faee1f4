"""Padded box containers.

Counterpart of detection_3d_tpu/models/structures.py: every box set is a
static-capacity (N, 7) yx_zb tensor with an (N,) validity mask and a
flat dict of equally-shaped per-box fields. The box sets of a unit of B
buildings lead with B: (B, N, 7), (B, N), and each operation acts on
every building's own N rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


class Boxes3D:
    """(N, 7) yx_zb boxes + (N,) validity + extra per-box fields."""

    def __init__(self, boxes, valid, fields: Optional[Dict] = None):
        self.boxes = boxes
        self.valid = valid
        self.fields = dict(fields or {})

    @property
    def capacity(self) -> int:
        return self.boxes.shape[-2]

    def clamp_size(self, min_size: float = 0.001) -> "Boxes3D":
        """Size floor applied to proposals before ROI pooling."""
        sizes = torch.clamp(self.boxes[..., 3:6], min=min_size)
        boxes = torch.cat([self.boxes[..., :3], sizes, self.boxes[..., 6:]],
                          -1)
        return Boxes3D(boxes, self.valid, self.fields)

    def gather(self, idx) -> "Boxes3D":
        """Select rows by index (idx == -1 rows become invalid); a unit's
        idx (B, K) selects in each building's own rows."""
        safe = torch.clamp(idx, 0, self.capacity - 1).to(torch.int64)
        valid = take_rows(self.valid, safe) & (idx >= 0)
        fields = {k: take_rows(v, safe) for k, v in self.fields.items()}
        return Boxes3D(take_rows(self.boxes, safe), valid, fields)


def take_rows(x, idx):
    """``x[..., idx, ...]`` along the rows axis of ``idx`` (its last), for
    every leading index: (..., N, *tail) by (..., K) -> (..., K, *tail)."""
    tail = x.shape[idx.ndim:]
    i = idx.reshape(idx.shape + (1,) * len(tail)).expand(idx.shape + tail)
    return torch.gather(x, idx.ndim - 1, i)


def concat_boxes(a: Boxes3D, b: Boxes3D, fields=()) -> Boxes3D:
    """Static concat of two padded box sets (both keep their masks and
    the named fields)."""
    return Boxes3D(torch.cat([a.boxes, b.boxes], -2),
                   torch.cat([a.valid, b.valid], -1),
                   {k: torch.cat([a.fields[k], b.fields[k]], -1)
                    for k in fields})
