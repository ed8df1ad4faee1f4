"""Analytic GEMM FLOPs of the detector, from one building's pyramid.

Counterpart of detection_3d_tpu/utils/flops.py. The reference keeps
multiply-add counters on the sparse convs
(SparseConvNet/sparseconvnet/submanifoldConvolution.py:85-94:
``nActive * kernel_volume * cin * cout``); this module counts the true
work of every conv, 2 * (real rulebook pairs) * Cin * Cout, from the
port's pyramid (models/backbone.build_pyramid: kernel B's books on the
card), plus the heads' GEMMs. These are the operations against which a
kernel A time reads as a roofline share, whatever implements the conv.

The JAX package also counts the one-hot gather of its TPU conv kernel
(``gather_overhead_flops``); the H100 kernels gather rows by index and
do no such work, so it has no counterpart here.
"""

from __future__ import annotations

from typing import Dict

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.models.backbone import build_pyramid


def _pairs(book, v_in, out_valid) -> int:
    """Real entries of a (K, V_out) book: an input row at a valid
    output row."""
    return int(((book != v_in) & out_valid[None, :]).sum())


def pyramid_pair_stats(cfg: Config, table0) -> Dict[str, list]:
    """Data-dependent rulebook statistics of one building (its scale-0
    table ``table0``), from build_pyramid. Lists indexed by scale (or
    downsample, or BEV slot):
      rows[s]        active voxels at scale s
      subm_pairs[s]  real (in, out) pairs over the 27 submanifold offsets
      down_pairs[k]  real pairs of downsample k (scale k -> k+1)
      up_pairs[k]    real pairs of deconv k (scale k+1 -> k)
      bev_rows/bev_pairs[slot]  BEV table rows / z-gather pairs
    """
    pyr = build_pyramid(table0, cfg)
    tables = pyr["tables"]
    rows = [int(t.row_valid.sum()) for t in tables]
    subm_pairs = [_pairs(b.idx, t.capacity, t.row_valid)
                  for b, t in zip(pyr["subm"], tables)]
    down_pairs = [_pairs(b.idx, tables[k].capacity, tables[k + 1].row_valid)
                  for k, b in enumerate(pyr["down"])]
    up_pairs = [_pairs(b.idx, tables[k + 1].capacity, tables[k].row_valid)
                for k, b in enumerate(pyr["up"])]
    n = len(tables)
    bev_rows, bev_pairs = [], []
    for slot, i_from_top in enumerate(cfg.rpn.rpn_scales_from_top):
        bev_t, book = pyr["bev"][slot]
        bev_rows.append(int(bev_t.row_valid.sum()))
        bev_pairs.append(_pairs(book.idx, tables[n - 1 - i_from_top].capacity,
                                bev_t.row_valid))
    return {"rows": rows, "subm_pairs": subm_pairs,
            "down_pairs": down_pairs, "up_pairs": up_pairs,
            "bev_rows": bev_rows, "bev_pairs": bev_pairs}


def model_gemm_flops(cfg: Config, stats: Dict[str, list],
                     is_train: bool = False) -> Dict[str, float]:
    """True GEMM FLOPs per stage (2 * pairs * Cin * Cout for sparse
    convs; 2 * rows * Cin * Cout for NiN/heads), mirroring the layer
    inventory of models/backbone.SparseFPN + the RPN/ROI heads."""
    s3d = cfg.sparse3d
    n_scales = s3d.num_scales
    planes = s3d.nplanes_front
    n_map = s3d.nplane_map
    reps = s3d.block_reps
    rows = stats["rows"]
    sp = stats["subm_pairs"]

    f: Dict[str, float] = {}
    f["conv_in"] = 2.0 * sp[0] * cfg.in_channels * planes[0]

    enc = 0.0
    for k in range(n_scales):
        if k > 0:
            enc += 2.0 * stats["down_pairs"][k - 1] * planes[k - 1] \
                * planes[k]
        for _ in range(reps):
            # residual block: two 3^3 convs planes[k]->planes[k]
            # (shortcut NiN only on a channel change, which the default
            # topology never hits inside a scale)
            n_convs = 2 if s3d.residual_block else 1
            enc += n_convs * 2.0 * sp[k] * planes[k] * planes[k]
    f["encoder"] = enc

    dec = 2.0 * rows[-1] * planes[-1] * n_map       # top shortcut NiN
    for j in range(n_scales - 2, -1, -1):
        dec += 2.0 * stats["up_pairs"][j] * n_map * n_map        # deconv
        dec += 2.0 * rows[j] * planes[j] * n_map                 # shortcut
        dec += 2.0 * sp[j] * n_map * n_map                       # merge
    f["decoder"] = dec

    f["bev"] = sum(2.0 * p * n_map * n_map for p in stats["bev_pairs"])

    # RPN head: shared 1x1 + cls + box on every map's rows
    a = cfg.rpn.num_anchors_per_location
    g = cfg.group_num if cfg.separate_rpn else 1
    n3d = len(cfg.rpn.rpn_scales_from_top)
    map_rows = []
    for sel in cfg.rpn.rpn_3d_2d_selector:
        if sel < n3d:
            map_rows.append(
                rows[n_scales - 1 - cfg.rpn.rpn_scales_from_top[sel]])
        else:
            map_rows.append(stats["bev_rows"][sel - n3d])
    n_rpn = sum(map_rows)
    f["rpn_head"] = 2.0 * n_rpn * n_map * (n_map + a * g + a * 7 * g)

    # ROI head on R proposals (per separate-classifier group)
    r = (cfg.roi.batch_size_per_image if is_train
         else cfg.rpn_post_nms_top_n_test)
    groups = cfg.group_num if cfg.separate_classes else 1
    os0, os1, os2 = cfg.roi.pooler_resolution
    rep = cfg.roi.mlp_head_dim
    nc = cfg.num_classes + len(cfg.separate_classes)
    per_roi = (2.0 * os0 * os1 * (os2 * n_map) * rep      # conv3d
               + 2.0 * (os0 * os1 * rep) * rep            # fc6
               + 2.0 * rep * rep                          # fc7
               + 2.0 * rep * (nc + nc * 7))               # predictor
    f["roi_head"] = groups * r * per_roi
    f["total"] = sum(f.values())
    return f
