"""The work of one building, counted from the problem: the voxel
coordinates, the channel widths and the dtypes, so that it reads the
same whatever implements it.

A sparse conv's operations are 2 * pairs * Cin * Cout, its pairs the
real (input row, output row) entries of its rulebook, found by the
reference's own plain search (reference/backbone.build_pyramid) on the
building's own voxels. Only the layers the forward computes are counted
(the decoder stops at the deepest map a head reads). A dense product's
operations are 2 * rows * Cin * Cout over the valid rows. Bytes count
each input and output byte of a call once: the valid input and output
rows, the weights and the rulebook's columns of the valid output rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from perfbench.reference.backbone import build_pyramid
from perfbench.reference.detector import voxelize_points

# NVIDIA's data sheet, H100 SXM, dense: bf16 / fp16 and float32 outside
# the tensor cores in FLOP/s, HBM3 in bytes/s (at the 700 W limit)
PEAKS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float16": 989e12,
                                   "float32": 67e12, "hbm": 3.35e12}}


def peaks(device_name: str):
    """The peaks of the card named ``device_name``, or None when the
    table has no such card."""
    return PEAKS.get(device_name)


@dataclass
class Conv:
    """One sparse conv of the forward, as kernel A runs it."""
    name: str
    k: int          # rulebook offsets
    pairs: int
    rows_in: int
    rows_out: int
    cin: int
    cout: int

    @property
    def flops(self) -> float:
        return 2.0 * self.pairs * self.cin * self.cout

    def bytes(self, esize: int) -> float:
        return (esize * (self.rows_in * self.cin + self.rows_out * self.cout
                         + self.k * self.cin * self.cout)
                + 4 * self.k * self.rows_out)


def _pairs(book, v_in: int, out_valid) -> int:
    return int(((book != v_in) & out_valid[None, :]).sum())


def forward_convs(cfg, pyr) -> List[Conv]:
    """Every sparse conv the forward computes, from the reference's
    pyramid ``pyr`` of one building (the inventory of SparseFPN)."""
    s3d = cfg.sparse3d
    n, planes, c_map = s3d.num_scales, s3d.nplanes_front, s3d.nplane_map
    tables = pyr["tables"]
    rows = [int(t.row_valid.sum()) for t in tables]
    subm = [_pairs(idx, t.capacity, t.row_valid)
            for idx, t in zip(pyr["subm_idx"], tables)]
    convs = [Conv("conv_in", 27, subm[0], rows[0], rows[0],
                  cfg.in_channels, planes[0])]
    for k in range(n):
        if k > 0:
            rb = pyr["down_rb"][k - 1]
            convs.append(Conv(f"down{k}", rb.shape[0],
                              _pairs(rb, tables[k - 1].capacity,
                                     tables[k].row_valid),
                              rows[k - 1], rows[k], planes[k - 1], planes[k]))
        for r in range(s3d.block_reps):
            for c in (1, 2) if s3d.residual_block else (1,):
                convs.append(Conv(f"block{k}_{r}.conv{c}", 27, subm[k],
                                  rows[k], rows[k], planes[k], planes[k]))
    n3d = len(cfg.rpn.rpn_scales_from_top)
    sel = cfg.rpn.rpn_3d_2d_selector
    used = {cfg.rpn.rpn_scales_from_top[i % n3d] for i in sel}
    used |= set(cfg.roi.pooler_scales_from_top)
    for i, k in enumerate(range(n - 1, 0, -1)):
        if i >= max(used):
            break
        j = k - 1
        rb = pyr["up_rb"][i]
        convs.append(Conv(f"up{j}", rb.shape[0],
                          _pairs(rb, tables[k].capacity, tables[j].row_valid),
                          rows[k], rows[j], c_map, c_map))
        convs.append(Conv(f"merge{j}", 27, subm[j], rows[j], rows[j],
                          c_map, c_map))
    for i in sel:
        if i < n3d:
            continue
        slot = i % n3d
        t3d = tables[n - 1 - cfg.rpn.rpn_scales_from_top[slot]]
        bev_t, rb = pyr["bev"][slot]
        convs.append(Conv(f"pro2d{slot}", rb.shape[0],
                          _pairs(rb, t3d.capacity, bev_t.row_valid),
                          int(t3d.row_valid.sum()),
                          int(bev_t.row_valid.sum()), c_map, c_map))
    return convs


def dense_flops(cfg, pyr, train: bool = False) -> float:
    """The forward's dense products: the NiN shortcuts the decoder
    reads, the RPN head on every selected map's valid rows, and the ROI
    head on each group's post-NMS proposals (``train``: on each group's
    sampled rows)."""
    s3d = cfg.sparse3d
    n, planes, c_map = s3d.num_scales, s3d.nplanes_front, s3d.nplane_map
    tables = pyr["tables"]
    rows = [int(t.row_valid.sum()) for t in tables]
    n3d = len(cfg.rpn.rpn_scales_from_top)
    sel = cfg.rpn.rpn_3d_2d_selector
    used = {cfg.rpn.rpn_scales_from_top[i % n3d] for i in sel}
    used |= set(cfg.roi.pooler_scales_from_top)
    f = 2.0 * rows[-1] * planes[-1] * c_map
    for i, k in enumerate(range(n - 1, 0, -1)):
        if i >= max(used):
            break
        f += 2.0 * rows[k - 1] * planes[k - 1] * c_map
    a = cfg.rpn.num_anchors_per_location
    g = cfg.group_num if cfg.separate_rpn else 1
    for i in sel:
        slot = i % n3d
        if i < n3d:
            r = rows[n - 1 - cfg.rpn.rpn_scales_from_top[slot]]
        else:
            r = int(pyr["bev"][slot][0].row_valid.sum())
        f += 2.0 * r * c_map * (c_map + a * g + a * 7 * g)
    os0, os1, os2 = cfg.roi.pooler_resolution
    rep = cfg.roi.mlp_head_dim
    nc = cfg.num_classes + len(cfg.separate_classes)
    per_roi = 2.0 * (os0 * os1 * os2 * c_map * rep + os0 * os1 * rep * rep
                     + rep * rep + rep * nc * 8)
    groups = cfg.group_num if cfg.separate_classes else 1
    rois = cfg.roi_batch_size_per_image if train else \
        cfg.rpn_post_nms_top_n_test
    return f + groups * rois * per_roi


@torch.no_grad()
def building_work(cfg, padded: Dict, device, train: bool = False) -> Dict:
    """The work on one padded building (reference/train.pad_scene): ``flops``
    of the whole forward (``train``: of the forward and its backward,
    three times the forward's products) and ``a_convs``, the sparse
    convs of kernel A."""
    pts, fts, valid = (torch.as_tensor(padded[k]).to(device)
                       for k in ("points", "feats", "points_valid"))
    pyr = build_pyramid(voxelize_points(cfg, pts, fts, valid), cfg)
    convs = forward_convs(cfg, pyr)
    flops = sum(c.flops for c in convs) + dense_flops(cfg, pyr, train)
    return {"flops": 3 * flops if train else flops, "a_convs": convs}


def least_seconds(convs: List[Conv], esize: int, peak: Dict,
                  dtype: str) -> float:
    """The least time the card could take for ``convs``, each bound by
    the larger of its operations over the peak rate and its bytes over
    the memory bandwidth."""
    return sum(max(c.flops / peak[dtype], c.bytes(esize) / peak["hbm"])
               for c in convs)


def backward_least_seconds(convs: List[Conv], esize: int, peak: Dict,
                           dtype: str) -> float:
    """The same for the backward of ``convs`` (kernel A'): dFeats of every
    conv but the first, whose input takes no gradient (the output's
    gradient, the weights and the transposed book in, the input's
    gradient out), and dW of every conv (the input, the output's
    gradient and the book in, float32 weights' gradient out)."""
    total = 0.0
    for i, c in enumerate(convs):
        rows = esize * (c.rows_in * c.cin + c.rows_out * c.cout)
        book = 4 * c.k * c.rows_out
        dw = rows + book + 4 * c.k * c.cin * c.cout
        total += max(c.flops / peak[dtype], dw / peak["hbm"])
        if i > 0:
            dfeats = rows + book + esize * c.k * c.cin * c.cout
            total += max(c.flops / peak[dtype], dfeats / peak["hbm"])
    return total
