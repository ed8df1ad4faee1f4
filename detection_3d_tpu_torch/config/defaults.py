"""Config system: frozen dataclass tree + the derived-config pass.

A copy of detection_3d_tpu/config/defaults.py (the port imports nothing
from the JAX package), plus :func:`full_scale_config`. Mirrors the
reference's yacs tree semantics
(reference maskrcnn_benchmark/config/defaults.py:21-326) and the
crucial derivations of intact_cfg
(reference tools/train_net_sparse3d.py:231-318): per-scale anchor
strides from cumulative conv strides, RPN map sizes, ROI spatial scales,
scene size, separate-classifier id groups and the 1.5/group_num top-N
rescale. Static capacities (padded array sizes) are an explicit section:
the reference's dynamic shapes become these caps, and every table and
rulebook of the port keeps them as its row count.

All values are hashable (tuples, not lists).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class Sparse3DConfig:
    voxel_scale: int = 50
    voxel_full_scale: Tuple[int, int, int] = (4096, 4096, 512)
    residual_block: bool = True
    block_reps: int = 1
    nplane_map: int = 128
    nplanes_front: Tuple[int, ...] = (32, 64, 64, 128, 128, 128, 256, 256, 256)
    kernels: Tuple[Tuple[int, int, int], ...] = ((2, 2, 2),) * 8
    strides: Tuple[Tuple[int, int, int], ...] = ((2, 2, 2),) * 8

    @property
    def num_scales(self) -> int:
        return len(self.nplanes_front)

    @property
    def scene_size(self) -> Tuple[float, float, float]:
        return tuple(s / self.voxel_scale for s in self.voxel_full_scale)

    def cumulative_strides(self):
        """Per-scale cumulative stride (scale 0 = (1,1,1))."""
        out = [(1, 1, 1)]
        for s in self.strides:
            out.append(tuple(a * b for a, b in zip(out[-1], s)))
        return tuple(out)

    def spatial_sizes(self):
        """Grid size per scale (ceil-divided by cumulative stride)."""
        out = []
        for cs in self.cumulative_strides():
            out.append(tuple(-(-d // s)
                             for d, s in zip(self.voxel_full_scale, cs)))
        return tuple(out)


@dataclass(frozen=True)
class RPNConfig:
    anchor_sizes_3d: Tuple[Tuple[float, float, float], ...] = (
        (0.4, 1.5, 1.5), (0.2, 0.5, 3.0), (0.4, 1.5, 3.0), (0.6, 2.5, 3.0))
    yaws: Tuple[float, ...] = (0.0, -1.57, -0.785, 0.785)
    ratios: Tuple[Tuple[float, float, float], ...] = (
        (1, 1, 1), (1, 2, 1), (2, 1, 1), (1.7, 1.7, 1))
    use_yaws: Tuple[int, ...] = (1, 1, 1, 1)
    fg_iou_threshold: float = 0.55
    bg_iou_threshold: float = 0.2
    yaw_threshold: float = 0.7
    batch_size_per_image: int = 256
    positive_fraction: float = 0.5
    nms_thresh: float = 0.5
    nms_aug_thickness_y_z: Tuple[float, float] = (0.3, 0.3)
    label_aug_thickness_y_tar_anc: Tuple[float, float] = (0.4, 0.0)
    label_aug_thickness_z_tar_anc: Tuple[float, float] = (0.8, 0.0)
    fpn_pre_nms_top_n_train: int = 2000
    fpn_pre_nms_top_n_test: int = 2000
    fpn_post_nms_top_n_train: int = 1000
    fpn_post_nms_top_n_test: int = 1000
    rpn_scales_from_top: Tuple[int, ...] = (4, 3, 2)
    rpn_3d_2d_selector: Tuple[int, ...] = (1, 3, 4, 5)
    add_gt_proposals: bool = True
    yaw_loss_mode: str = "Diff"

    @property
    def num_anchors_per_location(self) -> int:
        return len(self.yaws)


@dataclass(frozen=True)
class ROIConfig:
    fg_iou_threshold: float = 0.5
    bg_iou_threshold: float = 0.5
    bbox_reg_weights: Tuple[float, ...] = (1.0,) * 7
    batch_size_per_image: int = 512
    positive_fraction: float = 0.25
    score_thresh: float = 0.05
    nms: float = 0.45
    nms_aug_thickness_y_z: Tuple[float, float] = (0.2, 0.2)
    # static per-class NMS keep cap; the reference's boxlist_nms_3d
    # defaults max_proposals<=0 to 500 (boxlist_ops_3d.py:38-39)
    nms_post_cap: int = 500
    detections_per_img: int = 200
    label_aug_thickness_y_tar_anc: Tuple[float, float] = (0.4, 0.4)
    label_aug_thickness_z_tar_anc: Tuple[float, float] = (0.6, 0.6)
    pooler_resolution: Tuple[int, int, int] = (6, 8, 4)
    pooler_sampling_ratio: int = 2
    mlp_head_dim: int = 512
    canonical_size: float = 8.0
    pooler_scales_from_top: Tuple[int, ...] = (4, 3)


@dataclass(frozen=True)
class SolverConfig:
    base_lr: float = 0.001
    bias_lr_factor: float = 2.0
    momentum: float = 0.9
    weight_decay: float = 0.0005
    weight_decay_bias: float = 0.0
    gamma: float = 0.1
    lr_step_epochs: Tuple[int, ...] = (30,)
    warmup_factor: float = 1.0 / 3
    warmup_epochs: float = 0.5
    warmup_method: str = "linear"
    epochs: int = 100
    epochs_between_test: int = 10
    checkpoint_period_epochs: int = 20
    ims_per_batch: int = 1
    bn_momentum: float = 0.95
    track_running_stats: bool = False


@dataclass(frozen=True)
class TestConfig:
    ims_per_batch: int = 1
    iou_threshold: float = 0.2
    eval_aug_thickness_y_tar_anc: Tuple[float, float] = (0.2, 0.2)
    eval_aug_thickness_z_tar_anc: Tuple[float, float] = (0.2, 0.2)


@dataclass(frozen=True)
class CapacityConfig:
    """Static shapes: pad-to capacities for every dynamic
    count in the reference pipeline."""
    max_points: int = 500_000          # input points per batch
    voxel_caps: Tuple[int, ...] = ()   # per-scale table capacity ('' = auto)
    max_gt: int = 128                  # ground-truth boxes per example
    # lookup-grid budgets of the JAX package (dense row-index grid, xy
    # column grid). Kept so one config describes both packages; the port
    # answers every lookup with one int64 search and reads neither.
    dense_grid_max_entries: int = 1 << 26
    xy_grid_max_entries: int = 1 << 25

    def scale_caps(self, num_scales: int, base: Optional[int] = None):
        if self.voxel_caps:
            assert len(self.voxel_caps) == num_scales
            return self.voxel_caps
        base = base or (self.max_points // 2)
        caps = []
        c = base
        for _ in range(num_scales):
            caps.append(max(1024, c))
            c = c // 2
        return tuple(caps)


@dataclass(frozen=True)
class Config:
    classes: Tuple[str, ...] = ("background", "wall", "door", "window")
    elements: Tuple[str, ...] = ("xyz", "color", "normal")
    # dtype for backbone/head feature compute (geometry & losses stay f32)
    compute_dtype: str = "bfloat16"
    separate_classes: Tuple[Tuple[str, ...], ...] = ()
    separate_rpn: bool = True
    rpn_only: bool = False
    # every N epochs, postprocess the non-GT sampled proposals during
    # training and evaluate at epoch end (reference DEBUG.eval_in_train,
    # box_head.py:118-127 + trainer_sparse3d.py:95-104,165-172); 0 = off
    eval_in_train: int = 0
    backbone_out_channels: int = 128
    sparse3d: Sparse3DConfig = field(default_factory=Sparse3DConfig)
    rpn: RPNConfig = field(default_factory=RPNConfig)
    roi: ROIConfig = field(default_factory=ROIConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    test: TestConfig = field(default_factory=TestConfig)
    caps: CapacityConfig = field(default_factory=CapacityConfig)
    output_dir: str = "./RES"
    scenes: Tuple[str, ...] = ()

    # ---- derived quantities (intact_cfg equivalents) ---------------------

    @property
    def in_channels(self) -> int:
        widths = {"xyz": 3, "color": 3, "normal": 3}
        return sum(widths[e] for e in self.elements)

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    def dataset_metas(self):
        from detection_3d_tpu_torch.data.dataset_metas import DatasetMetas
        return DatasetMetas(self.classes)

    def ordered_class_names(self):
        """Class names by label id — CANONICAL SUNCG ordering
        (suncg_metas.py:2-30), not config order."""
        return self.dataset_metas().ordered_classes()

    def separate_classes_id(self):
        """Class-name groups -> label-id groups
        (train_net_sparse3d.py:238-244), using canonical label ids."""
        label_of = self.dataset_metas().class_2_label
        return tuple(tuple(label_of[c] for c in grp)
                     for grp in self.separate_classes)

    @property
    def group_num(self) -> int:
        return len(self.separate_classes) + 1

    def _sep_rescale(self, n: int) -> int:
        """1.5/group_num top-N rescale when separate groups are active
        (train_net_sparse3d.py:247-255)."""
        if not self.separate_classes:
            return n
        return int(1.5 / self.group_num * n)

    @property
    def rpn_pre_nms_top_n_train(self):
        return self._sep_rescale(self.rpn.fpn_pre_nms_top_n_train)

    @property
    def rpn_pre_nms_top_n_test(self):
        return self._sep_rescale(self.rpn.fpn_pre_nms_top_n_test)

    @property
    def rpn_post_nms_top_n_train(self):
        return self._sep_rescale(self.rpn.fpn_post_nms_top_n_train)

    @property
    def rpn_post_nms_top_n_test(self):
        return self._sep_rescale(self.rpn.fpn_post_nms_top_n_test)

    @property
    def roi_batch_size_per_image(self):
        return self._sep_rescale(self.roi.batch_size_per_image)

    @property
    def roi_detections_per_img(self):
        return self._sep_rescale(self.roi.detections_per_img)

    def validate(self):
        """Config-consistency asserts (intact_anchor,
        train_net_sparse3d.py:263-264)."""
        assert len(self.rpn.anchor_sizes_3d) == \
            len(self.rpn.rpn_3d_2d_selector) == len(self.rpn.use_yaws), (
                "one anchor size / use_yaws entry per SELECTED rpn map")
        if len(set(self.rpn.rpn_3d_2d_selector)) != \
                len(self.rpn.rpn_3d_2d_selector):
            # the RPN head computes logits from map features alone
            # (weights shared across levels, rpn_sparse3d.py:97-107):
            # two anchor types on the same map would get byte-identical
            # objectness/regression with conflicting targets and train
            # to garbage (r5 gate run 1)
            raise ValueError(
                f"rpn_3d_2d_selector={self.rpn.rpn_3d_2d_selector} "
                "repeats a map: anchor types on the same map are "
                "indistinguishable to the shared RPN head")
        assert len(self.rpn.yaws) == len(self.rpn.ratios)
        assert self.sparse3d.num_scales == len(self.sparse3d.strides) + 1
        # With separate_classes but a single (shared) RPN, groups >= 1
        # would silently never be trained or predicted — the detector
        # enumerates one proposal set per group.
        assert not (self.separate_classes and not self.separate_rpn), (
            "separate_classes requires separate_rpn=True: a shared RPN "
            "produces one proposal group, so separated classes would be "
            "silently dropped")
        # Honest config surface: reject rather than silently ignore.
        # Every real reference config runs TRACK_RUNNING_STATS=False
        # (batch statistics in eval too, configs/6c/*.yaml:43) and eval
        # parity depends on that; running-stats BN is not implemented.
        if self.solver.track_running_stats:
            raise NotImplementedError(
                "SOLVER.TRACK_RUNNING_STATS=True is not supported: BN "
                "uses batch statistics in train AND eval (the reference "
                "runs all real configs with False — "
                "batchNormalization.py:51-56). Set it to False.")
        # rpn_only's train aux output is the proposal list, not scored
        # detections — the eval-in-train accumulator would crash on it.
        assert not (self.rpn_only and self.eval_in_train), (
            "rpn_only and eval_in_train are mutually exclusive: the "
            "rpn-only train path has no ROI detections to evaluate")
        # The global top-K in roi postprocess draws from
        # (num_fg_classes * nms_post_cap) per-class NMS survivors; the
        # cap must leave enough rows to fill the detection budget.
        n_fg = max(len(self.classes) - 1, 1)
        assert n_fg * self.roi.nms_post_cap >= self.roi.detections_per_img, (
            f"roi.nms_post_cap={self.roi.nms_post_cap} too small: "
            f"{n_fg} fg classes x cap < "
            f"detections_per_img={self.roi.detections_per_img}")
        return self

    def anchor_strides(self):
        """Per-selected-level anchor stride (intact_anchor,
        train_net_sparse3d.py:257-287): cumulative strides indexed from the
        top, doubled for the 2D (BEV) copies, then picked by the
        3d/2d selector."""
        cum = self.sparse3d.cumulative_strides()  # len = num_scales
        from_top = [cum[len(cum) - 1 - i] for i in self.rpn.rpn_scales_from_top]
        doubled = from_top + from_top
        return tuple(doubled[i] for i in self.rpn.rpn_3d_2d_selector)

    def rpn_map_sizes(self):
        """Grid size of each selected RPN level (check_roi_parameters,
        train_net_sparse3d.py:298-310)."""
        sizes = self.sparse3d.spatial_sizes()
        from_top = [sizes[len(sizes) - 1 - i]
                    for i in self.rpn.rpn_scales_from_top]
        return tuple(from_top)

    def roi_spatial_scales(self):
        """1/stride of each ROI pooling level (train_net_sparse3d.py:312-318).
        xy strides must agree per level."""
        cum = self.sparse3d.cumulative_strides()
        out = []
        for i in self.roi.pooler_scales_from_top:
            cs = cum[len(cum) - 1 - i]
            assert cs[0] == cs[1]
            out.append(1.0 / cs[0])
        return tuple(out)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def default_config() -> Config:
    return Config()


def full_scale_config() -> Config:
    """Reference-scale 6-class config (6c_Fpn4321_bs1_lr5.yaml): a
    4096 x 4096 x 512 grid, 9 scales, 500k input points. The same values
    as ``full_scale_config`` in the JAX package's bench.py."""
    return Config(
        classes=("background", "wall", "door", "window", "ceiling", "floor"),
        sparse3d=Sparse3DConfig(
            voxel_scale=50,
            voxel_full_scale=(4096, 4096, 512),
            nplanes_front=(32, 64, 64, 128, 128, 128, 256, 256, 256),
            kernels=((2, 2, 2),) * 8,
            strides=((2, 2, 2),) * 8,
        ),
        rpn=RPNConfig(
            rpn_scales_from_top=(4, 3, 2, 1),
            rpn_3d_2d_selector=(1, 2, 3, 4, 5, 6),
            anchor_sizes_3d=((0.4, 1.5, 1.5), (1.5, 1.5, 1.0), (4, 4, 1.5),
                             (0.2, 0.5, 3), (0.4, 1.5, 3), (0.6, 2.5, 3)),
            use_yaws=(1, 0, 0, 1, 1, 1),
        ),
        caps=CapacityConfig(
            max_points=500_000,
            voxel_caps=(524288, 262144, 131072, 65536, 32768,
                        16384, 8192, 4096, 2048),
            max_gt=512,
            dense_grid_max_entries=1 << 28),
    )


def small_config() -> Config:
    """The reduced 6-class config of the JAX package's ``bench.py --small``
    (a 1024 x 1024 x 256 grid, 7 scales, 120k input points); the same
    values as ``small_config`` there."""
    return Config(
        classes=("background", "wall", "door", "window", "ceiling", "floor"),
        sparse3d=Sparse3DConfig(
            voxel_scale=50,
            voxel_full_scale=(1024, 1024, 256),
            nplanes_front=(32, 64, 64, 128, 128, 128, 256),
            kernels=((2, 2, 2),) * 6,
            strides=((2, 2, 2),) * 6,
        ),
        rpn=RPNConfig(
            rpn_scales_from_top=(4, 3, 2),
            rpn_3d_2d_selector=(1, 3, 4, 5),
            anchor_sizes_3d=((0.4, 1.5, 1.5), (0.2, 0.5, 3), (0.4, 1.5, 3),
                             (0.6, 2.5, 3)),
            use_yaws=(1, 1, 1, 1),
        ),
        caps=CapacityConfig(
            max_points=120_000,
            voxel_caps=(65536, 32768, 16384, 8192, 4096, 2048, 1024),
            max_gt=64,
            dense_grid_max_entries=1 << 28),
    )
