"""MinkUNet34C: the sparse-voxel UNet of MinkowskiEngine's
``examples/minkunet.py`` (Choy, Gwak and Savarese, "4D Spatio-Temporal
ConvNets", CVPR 2019) on the port's sparse ops, trained by per-voxel
cross-entropy through engine/trainer's ``Trainer.step``.

Layers (D = 3; every conv bias-free but the classifier's; a stride-1
conv keeps its input's sites, i.e. it is submanifold)::

    p1 = ReLU(BN(conv5^3(x)))                                  the stem
    e_k = block_k(ReLU(BN(conv2^3/s2(e_{k-1}))))    k = 1..4, e_0 = p1
    d_j = block_{8-j}(cat(ReLU(BN(convT2^3/s2(d_{j+1}))), e_j))
                                                    j = 3..0, d_4 = e_4
    out = conv1^3(d_0) + bias
    BasicBlock(x, cin -> c): y = ReLU(BN(conv3^3(x))); y = BN(conv3^3(y));
        r = x if cin == c else BN(conv1^3(x)); ReLU(y + r)

with LAYERS (2, 3, 4, 6, 2, 2, 2, 2), PLANES (32, 64, 128, 256, 256,
128, 96, 96) and INIT_DIM 32; the upsampled features come first in each
concatenation, as ``ME.cat(out, out_bXpY)``. Modules carry ME's names
(``conv0p1s1``, ``bn0``, ``block1.0.conv1``, ``convtr4p16s2``, ...).

The levels are planned once a forward (span ``model.plan``):
models/backbone.pyramid_levels gives the five levels' tables, the
2^3/stride-2 conv and deconv books and each level's 3^3 book (kernel B),
and kernel B's 5x5x5 form the stem's 125-offset book beside level 0's,
with its two-word row masks (ops/sparse_conv.RowOrder). Every conv runs
on kernel A and its backward on A'; the stem's input wants no gradient,
so its backward book holds dW's entry lists alone
(ops/sparse_conv.weights_book). BN is ops/norm's masked batch-statistics
BN at eps 1e-5 (ME's MinkowskiBatchNorm in training), followed by a ReLU
or, at slope 1, by nothing. Parameters are kept in float32 and cast to
``compute_dtype`` at use; the logits and the loss are float32.

Training: :meth:`MinkUNet34C.training_losses` is the model's loss
method, which engine/trainer's ``Trainer`` calls. The padded points
(data/packing.pad_scene with ``point_labels``) are voxelized: a
voxel's features are the mean of its points' colours, and its label the
one its points share; a voxel whose points disagree, or carry none
(-1), is ignored. Both come from a per-voxel min and max of
the points' labels on the card. The loss is the mean cross-entropy over
the labelled voxels (:func:`segmentation_loss`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from detection_3d_tpu_torch.config.defaults import (
    CapacityConfig, SolverConfig,
)
from detection_3d_tpu_torch.models.backbone import (
    BNLeakyReLU, NiN, SubmConv, he_normal_, pyramid_levels,
)
from detection_3d_tpu_torch.ops.sparse import (
    SparseTensor, build_sparse_tensor, neighbor_match,
)
from detection_3d_tpu_torch.ops.sparse_conv import (
    Book, masks_row_order, nin_conv, sparse_conv, weights_book,
)
from detection_3d_tpu_torch.utils.profiling import span

LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)
PLANES = (32, 64, 128, 256, 256, 128, 96, 96)
INIT_DIM = 32
LEVELS = 5
KERNEL = (2, 2, 2)      # the strided convs and their transposes, stride 2
STEM_VOLUME = 125       # the 5^3 stem
BN_EPS = 1e-5           # ME's MinkowskiBatchNorm
_ELEMENT_WIDTH = 3      # each of xyz, color, normal


@dataclass(frozen=True)
class MinkUNetConfig:
    """A segmentation run's configuration: the network's widths, its
    input and what engine/trainer reads of a configuration (``solver``,
    ``caps``, ``in_channels``, ``eval_in_train``, ``output_dir``).

    ``elements`` are the feature columns pad_scene keeps, in a scene's
    [xyz | color | normal] order; the network reads the colour (3
    channels). ``caps.voxel_caps`` sizes the five levels' tables;
    ``caps.max_gt`` the boxes pad_scene keeps."""
    eval_in_train: ClassVar[int] = 0    # nothing to detect
    classes: Tuple[str, ...] = ("background", "wall", "door", "window",
                                "ceiling", "floor")
    elements: Tuple[str, ...] = ("xyz", "color")
    out_channels: int = 20
    layers: Tuple[int, ...] = LAYERS
    planes: Tuple[int, ...] = PLANES
    init_dim: int = INIT_DIM
    compute_dtype: str = "bfloat16"
    voxel_full_scale: Tuple[int, int, int] = (4096, 4096, 512)
    solver: SolverConfig = field(default_factory=SolverConfig)
    caps: CapacityConfig = field(default_factory=lambda: CapacityConfig(
        voxel_caps=(524288, 524288, 524288, 262144, 65536), max_gt=512))
    output_dir: str = "./RES"

    @property
    def in_channels(self) -> int:
        """The feature columns pad_scene keeps."""
        return _ELEMENT_WIDTH * len(self.elements)

    @property
    def feature_columns(self) -> slice:
        """The network's input columns, the colour, among those pad_scene
        keeps."""
        at = _ELEMENT_WIDTH * self.elements.index("color")
        return slice(at, at + _ELEMENT_WIDTH)

    def validate(self) -> "MinkUNetConfig":
        if len(self.layers) != 8 or len(self.planes) != 8:
            raise ValueError("MinkUNetConfig: 8 layers and 8 planes, one "
                             "a stage of blocks")
        if len(self.caps.voxel_caps) != LEVELS:
            raise ValueError(f"MinkUNetConfig: caps.voxel_caps sizes the "
                             f"{LEVELS} levels' tables")
        if "color" not in self.elements:
            raise ValueError("MinkUNetConfig: the network reads the colour, "
                             "so the elements keep it")
        return self


def segmentation_loss(logits, labels):
    """Mean cross-entropy of (V, C) float32 logits over the rows whose
    (V,) int64 label is >= 0 (0 when there are none); no host sync."""
    n = (labels >= 0).sum().clamp(min=1)
    return F.cross_entropy(logits, labels, ignore_index=-1,
                           reduction="sum") / n


def voxel_labels(row_map, point_labels, row_valid):
    """(V,) int64 voxel labels: the label a voxel's points share, -1
    where they disagree or carry -1, or on a pad row. ``row_map`` (P,)
    gives each point's row (V for a point off the table), as
    ops/sparse.build_sparse_tensor(return_row_map=True) returns it."""
    v = row_valid.shape[0]
    lab = point_labels.to(torch.int32)
    big = torch.iinfo(torch.int32).max
    slot = row_map.to(torch.int64)
    lo = torch.full((v + 1,), big, dtype=torch.int32, device=lab.device)
    hi = torch.full((v + 1,), -big, dtype=torch.int32, device=lab.device)
    lo = lo.scatter_reduce(0, slot, lab, "amin")[:v]
    hi = hi.scatter_reduce(0, slot, lab, "amax")[:v]
    return torch.where(row_valid & (lo == hi) & (lo >= 0), lo,
                       -1).to(torch.int64)


class SampleConv(nn.Module):
    """A 2^3 stride-2 conv over its book (a downsample's conv book, or its
    deconv book back onto the finer level), bias-free."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(KERNEL[0] * KERNEL[1] * KERNEL[2],
                                          cin, cout))

    def reset_parameters(self, gen):
        he_normal_(self.w, gen)

    def forward(self, feats, book, out_valid):
        return sparse_conv(feats, book, self.w.to(feats.dtype), out_valid)


class BasicBlock(nn.Module):
    """ME's BasicBlock (see the module docstring) on a level's 3^3 book."""

    def __init__(self, cin: int, c: int, eps: float):
        super().__init__()
        self.conv1 = SubmConv(cin, c)
        self.bn1 = BNLeakyReLU(c, 0.0, eps)
        self.conv2 = SubmConv(c, c)
        self.bn2 = BNLeakyReLU(c, 1.0, eps)
        self.downsample = NiN(cin, c) if cin != c else None
        self.bn_down = BNLeakyReLU(c, 1.0, eps) if cin != c else None

    def forward(self, x, book, valid):
        y = self.bn1(self.conv1(x, book, valid), valid)
        y = self.bn2(self.conv2(y, book, valid), valid)
        r = x if self.downsample is None else \
            self.bn_down(self.downsample(x, valid), valid)
        return torch.relu(y + r)


class Classifier(nn.Module):
    """The final 1^3 conv with its bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen):
        he_normal_(self.w, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, feats, valid):
        logits = nin_conv(feats, self.w.to(feats.dtype), valid).float()
        return torch.where(valid[:, None], logits + self.bias, 0.0)


_DOWN = ("conv1p1s2", "conv2p2s2", "conv3p4s2", "conv4p8s2")
_UP = ("convtr4p16s2", "convtr5p8s2", "convtr6p4s2", "convtr7p2s2")


class MinkUNet34C(nn.Module):
    """MinkUNet34C (module docstring): ``forward(table)`` gives the (V,
    out_channels) float32 logits of the level-0 table's rows (zero on pad
    rows). ``caps`` sizes the five levels' tables (default: each the
    input table's capacity); widths other than ME's are for tests."""

    def __init__(self, in_channels: int = 3, out_channels: int = 20,
                 seed: int = 0, planes: Sequence[int] = PLANES,
                 layers: Sequence[int] = LAYERS, init_dim: int = INIT_DIM,
                 caps: Optional[Sequence[int]] = None,
                 compute_dtype: str = "bfloat16"):
        super().__init__()
        self.caps = None if caps is None else tuple(caps)
        self.compute_dtype = compute_dtype
        eps = BN_EPS
        self.conv0p1s1 = SubmConv(in_channels, init_dim, STEM_VOLUME)
        self.bn0 = BNLeakyReLU(init_dim, 0.0, eps)
        cin = init_dim
        for k, name in enumerate(_DOWN):
            self.add_module(name, SampleConv(cin, cin))
            self.add_module(f"bn{k + 1}", BNLeakyReLU(cin, 0.0, eps))
            cin = self._stage(f"block{k + 1}", cin, planes[k], layers[k],
                              eps)
        skips = (planes[2], planes[1], planes[0], init_dim)
        for j, name in enumerate(_UP):
            self.add_module(name, SampleConv(cin, planes[4 + j]))
            self.add_module(f"bntr{4 + j}", BNLeakyReLU(planes[4 + j], 0.0,
                                                        eps))
            cin = self._stage(f"block{5 + j}", planes[4 + j] + skips[j],
                              planes[4 + j], layers[4 + j], eps)
        self.final = Classifier(cin, out_channels)
        self.reset_parameters(seed)

    def _stage(self, name: str, cin: int, c: int, n: int, eps: float) -> int:
        self.add_module(name, nn.ModuleList(
            [BasicBlock(cin if i == 0 else c, c, eps) for i in range(n)]))
        return c

    @classmethod
    def from_config(cls, cfg: MinkUNetConfig, seed: int = 0):
        return cls(_ELEMENT_WIDTH, cfg.out_channels, seed, cfg.planes,
                   cfg.layers, cfg.init_dim, cfg.caps.voxel_caps,
                   cfg.compute_dtype)

    def reset_parameters(self, seed: int):
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(gen)

    def priority_shapes(self) -> Dict[str, int]:
        """The sampler draws a step takes: none (the trainer's contract
        with the detector, whose samplers draw)."""
        return {}

    def plan(self, table: SparseTensor, backward: bool) -> Dict:
        """The five levels' :func:`pyramid_levels` dict (tables, subm,
        down, up; every book an ops/sparse_conv.Book, in level order) and
        ``stem``, the Book of the stem's 5^3 book; with ``backward`` every
        Book holds its backward book (span ``model.plan``, whose
        attributes are the voxels a level and the 5^3 book's real
        entries)."""
        with span("model.plan") as sp:
            caps = self.caps or (table.capacity,) * LEVELS
            lv = pyramid_levels(table, (KERNEL,) * (LEVELS - 1),
                                (KERNEL,) * (LEVELS - 1), caps, backward)
            idx, masks = neighbor_match(table, radius=2)
            lv["stem"] = Book(idx, masks_row_order(masks), weights_book(
                idx, table.rows, table.row_valid.reshape(-1))
                if backward else None)
            if sp is not None:
                sp.attributes = {
                    "voxels": torch.stack([t.num for t in lv["tables"]]),
                    "stem_pairs": (idx < table.rows).sum()}
        return lv

    def features(self, table: SparseTensor):
        """(V, planes[7]) features of the level-0 rows, in the compute
        dtype."""
        lv = self.plan(table, torch.is_grad_enabled())
        valid = [t.row_valid for t in lv["tables"]]
        x = table.feats.to(getattr(torch, self.compute_dtype))
        with span("model.stem"):
            h = self.bn0(self.conv0p1s1(x, lv["stem"], valid[0]), valid[0])
        skips = [h]
        with span("model.encoder"):
            for k, name in enumerate(_DOWN, 1):
                h = getattr(self, f"bn{k}")(getattr(self, name)(
                    h, lv["down"][k - 1], valid[k]), valid[k])
                for block in getattr(self, f"block{k}"):
                    h = block(h, lv["subm"][k], valid[k])
                skips.append(h)
        with span("model.decoder"):
            for j, name in enumerate(_UP):
                k = LEVELS - 2 - j
                u = getattr(self, f"bntr{4 + j}")(getattr(self, name)(
                    h, lv["up"][k], valid[k]), valid[k])
                h = torch.cat([u, skips[k]], -1)
                for block in getattr(self, f"block{5 + j}"):
                    h = block(h, lv["subm"][k], valid[k])
        return h

    def forward(self, table: SparseTensor):
        h = self.features(table)
        with span("model.head"):
            return self.final(h, table.row_valid)

    def voxelize(self, cfg: MinkUNetConfig, points, feats, valid,
                 point_labels):
        """(level-0 table of the colour columns, (V,) int64 voxel labels)
        of one building's padded points (module docstring)."""
        coords = torch.floor(points).to(torch.int32)
        coords4 = torch.cat([coords, torch.zeros_like(coords[:, :1])], -1)
        table, row_map = build_sparse_tensor(
            coords4, feats[:, cfg.feature_columns], valid,
            cfg.voxel_full_scale, 1, cfg.caps.voxel_caps[0],
            return_row_map=True)
        return table, voxel_labels(row_map, point_labels, table.row_valid)

    def training_losses(self, cfg: MinkUNetConfig, batch, device,
                        generator=None, priorities=None, packed=False):
        """The training forward of one padded building (pad_scene's dict
        with ``point_labels``): ({"loss_seg": the mean cross-entropy},
        None (no detections), the level-0 voxels before the cap)."""
        if packed is not False:
            raise ValueError("MinkUNet34C trains on padded points only")
        if "point_labels" not in batch:
            raise ValueError("MinkUNet34C.training_losses: the batch has "
                             "no point_labels (pad_scene carries a "
                             "scene's)")
        b = {k: torch.as_tensor(batch[k]).to(device)
             for k in ("points", "feats", "points_valid", "point_labels")}
        table, labels = self.voxelize(cfg, b["points"], b["feats"],
                                      b["points_valid"], b["point_labels"])
        h = self.features(table)
        with span("model.head"):
            loss = segmentation_loss(self.final(h, table.row_valid), labels)
        return {"loss_seg": loss}, None, table.true_num
