"""A second model family, for the harness's tests: per-voxel
segmentation by the port's ``SparseUNet`` (models/factories.py) over
``plan_levels`` of the voxelized building, with a per-voxel linear head.
Its float32 reference is the plain twin below, built from the
reference's sparse layers (reference/backbone.py, reference/sparse.py),
under the same parameter names. The tests copy this file into a
checkout root as ``perfbench/families/tiny_unet.py``, beside the window
that serves it (``second_family/segment.py``); families/sparse_rcnn.py
states what a family gives.

The configuration's ``model``: ``classes`` (the pool's), ``num_classes``,
``in_channels`` (the building's first feature columns), ``nplanes`` (one
width a level), ``caps`` (one table size a level), ``max_points``,
``voxel_full_scale`` and ``compute_dtype``.

An answer is {"logits": (V, num_classes)} of the building's valid voxel
rows, in table order. ``logit_gap`` is the largest gap of a logit over
the largest magnitude of the reference's (1 when the rows differ in
number).
"""

from __future__ import annotations

import math
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch
from torch import nn

LIMIT_NAMES = frozenset({"logit_gap"})
WIDTHS = ("in_channels", "nplanes", "num_classes")
KERNEL = (2, 2, 2)


def program_config(config_file: Dict, override: Dict = None):
    return SimpleNamespace(**dict(config_file["model"], **(override or {})))


def reference_config(config_file: Dict):
    return program_config(config_file, {"compute_dtype": "float32"})


def _inputs(cfg, scene: Dict, device):
    """The building's first ``max_points`` points as int voxel coords
    (x, y, z, 0) and their first ``in_channels`` features."""
    m = min(len(scene["points"]), cfg.max_points)
    pts = torch.as_tensor(scene["points"][:m], device=device)
    coords = torch.floor(pts).to(torch.int32)
    coords4 = torch.cat([coords, torch.zeros_like(coords[:, :1])], -1)
    feats = torch.as_tensor(scene["feats"][:m, :cfg.in_channels],
                            device=device)
    return coords4, feats


class Segmenter(nn.Module):
    """The program: the port's voxelization, plan and SparseUNet, then
    the head."""

    def __init__(self, cfg):
        super().__init__()
        from detection_3d_tpu_torch.models.factories import SparseUNet
        self.cfg = cfg
        self.unet = SparseUNet(cfg.in_channels, cfg.nplanes,
                               kernel_volume=math.prod(KERNEL))
        self.head_w = nn.Parameter(torch.empty(cfg.nplanes[0],
                                               cfg.num_classes))
        self.head_b = nn.Parameter(torch.empty(cfg.num_classes))

    @torch.no_grad()
    def segment(self, scene: Dict, device) -> Dict[str, np.ndarray]:
        from detection_3d_tpu_torch.models.factories import plan_levels
        from detection_3d_tpu_torch.ops.sparse import build_sparse_tensor
        coords, feats = _inputs(self.cfg, scene, device)
        table = build_sparse_tensor(coords, feats, None,
                                    self.cfg.voxel_full_scale, 1,
                                    self.cfg.caps[0])
        plan = plan_levels(table, self.cfg.caps, KERNEL, KERNEL)
        h = self.unet(plan)
        logits = h @ self.head_w + self.head_b
        return {"logits": logits[table.row_valid].cpu().numpy()}


def reference_levels(cfg, scene: Dict, device):
    """The reference's voxel table of the building and its levels."""
    from perfbench.reference.backbone import pyramid_levels
    from perfbench.reference.sparse import build_sparse_tensor
    coords, feats = _inputs(cfg, scene, device)
    table = build_sparse_tensor(coords, feats, None, cfg.voxel_full_scale,
                                1, cfg.caps[0])
    n = len(cfg.caps)
    return pyramid_levels(table, (KERNEL,) * (n - 1), (KERNEL,) * (n - 1),
                          cfg.caps)


class _TwinUNet(nn.Module):
    """SparseUNet's plain twin (reps 1, no residual): BN-ReLU and conv a
    level on the way down, a strided conv down, a deconv up, the
    concatenation, then BN-ReLU and conv."""

    def __init__(self, cin: int, nplanes):
        super().__init__()
        from perfbench.reference.backbone import (
            BNLeakyReLU, DownLayer, SubmConv, UpLayer)
        self.n = len(nplanes)
        vol = math.prod(KERNEL)
        for k, c in enumerate(nplanes):
            self.add_module(f"enc{k}_bn0", BNLeakyReLU(cin))
            self.add_module(f"enc{k}_conv0", SubmConv(cin, c))
            if k < self.n - 1:
                self.add_module(f"down{k}", DownLayer(c, nplanes[k + 1],
                                                      vol))
                self.add_module(f"up{k}", UpLayer(nplanes[k + 1], c, vol))
                self.add_module(f"dec{k}_bn0", BNLeakyReLU(2 * c))
                self.add_module(f"dec{k}_conv0", SubmConv(2 * c, c))
            cin = c

    def _block(self, tag, h, lv, k):
        valid = lv["tables"][k].row_valid
        h = getattr(self, f"{tag}_bn0")(h, valid)
        return getattr(self, f"{tag}_conv0")(h, lv["subm_idx"][k], valid,
                                             lv["subm_order"][k])

    def forward(self, lv, h, k: int = 0):
        h = self._block(f"enc{k}", h, lv, k)
        if k == self.n - 1:
            return h
        v, w = lv["tables"][k].row_valid, lv["tables"][k + 1].row_valid
        d = getattr(self, f"down{k}")(h, lv["down_rb"][k], v, w,
                                      lv["down_order"][k])
        d = self.forward(lv, d, k + 1)
        u = getattr(self, f"up{k}")(d, lv["up_rb"][k], w, v,
                                    lv["up_order"][k])
        return self._block(f"dec{k}", torch.cat([h, u], -1), lv, k)


class Twin(nn.Module):
    """The reference: the reference's voxelization and levels, the twin
    UNet, the head."""

    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.unet = _TwinUNet(cfg.in_channels, cfg.nplanes)
        self.head_w = nn.Parameter(torch.empty(cfg.nplanes[0],
                                               cfg.num_classes))
        self.head_b = nn.Parameter(torch.empty(cfg.num_classes))

    @torch.no_grad()
    def segment(self, scene: Dict, device) -> Dict[str, np.ndarray]:
        lv = reference_levels(self.cfg, scene, device)
        table = lv["tables"][0]
        logits = self.unet(lv, table.feats) @ self.head_w + self.head_b
        return {"logits": logits[table.row_valid].cpu().numpy()}


def program_model(cfg):
    from perfbench.inputs import meta_model
    return meta_model(Segmenter, cfg)


def reference_model(ref_cfg):
    from perfbench.inputs import meta_model
    return meta_model(Twin, ref_cfg)


def init_std(name: str, shape) -> float:
    return math.sqrt(2.0 / math.prod(shape[:-1]))


def reference_pad(ref_cfg, scene: Dict) -> Dict:
    return scene


def reference_answer(run, model, building: int) -> Dict:
    return model.segment(run.pool[building], run.device)


def serving_numbers(run, answer: Dict, ref, building: int
                    ) -> Dict[str, float]:
    got = answer["logits"].astype(np.float64)
    want = reference_answer(run, ref, building)["logits"]
    if got.shape != want.shape:
        return {"logit_gap": 1.0}
    top = max(float(np.abs(want).max()), 1e-30)
    return {"logit_gap": float(np.abs(got - want).max()) / top}


def building_work(ref_cfg, padded: Dict, device, train: bool = False
                  ) -> Dict:
    """The UNet's sparse convs, counted on the reference's levels, and
    the head's product."""
    from perfbench.counts import Conv
    lv = reference_levels(ref_cfg, padded, device)
    tables = lv["tables"]
    rows = [int(t.row_valid.sum()) for t in tables]

    def pairs(book, v_in, out_valid):
        return int(((book != v_in) & out_valid[None, :]).sum())

    subm = [pairs(b, t.capacity, t.row_valid)
            for b, t in zip(lv["subm_idx"], tables)]
    planes, cin, convs = ref_cfg.nplanes, ref_cfg.in_channels, []
    for k, c in enumerate(planes):
        convs.append(Conv(f"enc{k}", 27, subm[k], rows[k], rows[k], cin, c))
        if k < len(planes) - 1:
            book = lv["down_rb"][k]
            convs.append(Conv(f"down{k}", book.shape[0],
                              pairs(book, tables[k].capacity,
                                    tables[k + 1].row_valid),
                              rows[k], rows[k + 1], c, planes[k + 1]))
            book = lv["up_rb"][k]
            convs.append(Conv(f"up{k}", book.shape[0],
                              pairs(book, tables[k + 1].capacity,
                                    tables[k].row_valid),
                              rows[k + 1], rows[k], planes[k + 1], c))
            convs.append(Conv(f"dec{k}", 27, subm[k], rows[k], rows[k],
                              2 * c, c))
        cin = c
    flops = sum(c.flops for c in convs) + \
        2.0 * rows[0] * planes[0] * ref_cfg.num_classes
    return {"flops": 3 * flops if train else flops, "a_convs": convs}


def control(model):
    from perfbench.control import fp8
    from perfbench.reference import backbone
    return fp8(model, (backbone.SubmConv, backbone.DownLayer))
