"""YAML overlay loader: consume reference-style config files.

A copy of detection_3d_tpu/config/yaml_loader.py. Accepts the
reference's YAML layout (configs/{4c,6c,3G6c,CF,...}, keyed by
MODEL/SPARSE3D/SOLVER/INPUT/TEST as in the reference's
maskrcnn_benchmark/config/defaults.py) and produces a frozen Config.
Unknown keys are ignored with a warning, so reference configs load
as-is.
"""

from __future__ import annotations

import ast
import dataclasses
import logging

from detection_3d_tpu_torch.config.defaults import Config

logger = logging.getLogger(__name__)


def _t(x):
    """Deep-convert lists to tuples (the config holds hashable values)."""
    if isinstance(x, (list, tuple)):
        return tuple(_t(v) for v in x)
    return x


def _parse_value(v):
    """Reference YAMLs contain python-tuple strings like '(6,8,4)'."""
    if isinstance(v, str):
        try:
            return ast.literal_eval(v)
        except (ValueError, SyntaxError):
            return v
    return v


def _load_yaml(path):
    try:
        import yaml  # type: ignore
    except ImportError:
        raise RuntimeError("pyyaml is required to load YAML configs")
    with open(path) as f:
        return yaml.safe_load(f)


# (yaml section, yaml key) -> (config sub-tree, field name)
_MAPPING = {
    ("INPUT", "CLASSES"): ("", "classes"),
    ("INPUT", "ELEMENTS"): ("", "elements"),
    ("INPUT", "SCENES"): ("", "scenes"),
    ("MODEL", "SEPARATE_CLASSES"): ("", "separate_classes"),
    ("MODEL", "SEPARATE_RPN"): ("", "separate_rpn"),
    ("MODEL", "RPN_ONLY"): ("", "rpn_only"),
    ("MODEL.BACKBONE", "OUT_CHANNELS"): ("", "backbone_out_channels"),
    ("SPARSE3D", "VOXEL_SCALE"): ("sparse3d", "voxel_scale"),
    ("SPARSE3D", "VOXEL_FULL_SCALE"): ("sparse3d", "voxel_full_scale"),
    ("SPARSE3D", "RESIDUAL_BLOCK"): ("sparse3d", "residual_block"),
    ("SPARSE3D", "BLOCK_REPS"): ("sparse3d", "block_reps"),
    ("SPARSE3D", "nPlaneMap"): ("sparse3d", "nplane_map"),
    ("SPARSE3D", "nPlanesFront"): ("sparse3d", "nplanes_front"),
    ("SPARSE3D", "KERNEL"): ("sparse3d", "kernels"),
    ("SPARSE3D", "STRIDE"): ("sparse3d", "strides"),
    ("MODEL.RPN", "ANCHOR_SIZES_3D"): ("rpn", "anchor_sizes_3d"),
    ("MODEL.RPN", "YAWS"): ("rpn", "yaws"),
    ("MODEL.RPN", "RATIOS"): ("rpn", "ratios"),
    ("MODEL.RPN", "USE_YAWS"): ("rpn", "use_yaws"),
    ("MODEL.RPN", "FG_IOU_THRESHOLD"): ("rpn", "fg_iou_threshold"),
    ("MODEL.RPN", "BG_IOU_THRESHOLD"): ("rpn", "bg_iou_threshold"),
    ("MODEL.RPN", "YAW_THRESHOLD"): ("rpn", "yaw_threshold"),
    ("MODEL.RPN", "BATCH_SIZE_PER_IMAGE"): ("rpn", "batch_size_per_image"),
    ("MODEL.RPN", "POSITIVE_FRACTION"): ("rpn", "positive_fraction"),
    ("MODEL.RPN", "NMS_THRESH"): ("rpn", "nms_thresh"),
    ("MODEL.RPN", "NMS_AUG_THICKNESS_Y_Z"): ("rpn", "nms_aug_thickness_y_z"),
    ("MODEL.RPN", "LABEL_AUG_THICKNESS_Y_TAR_ANC"):
        ("rpn", "label_aug_thickness_y_tar_anc"),
    ("MODEL.RPN", "LABEL_AUG_THICKNESS_Z_TAR_ANC"):
        ("rpn", "label_aug_thickness_z_tar_anc"),
    ("MODEL.RPN", "FPN_PRE_NMS_TOP_N_TRAIN"): ("rpn", "fpn_pre_nms_top_n_train"),
    ("MODEL.RPN", "FPN_PRE_NMS_TOP_N_TEST"): ("rpn", "fpn_pre_nms_top_n_test"),
    ("MODEL.RPN", "FPN_POST_NMS_TOP_N_TRAIN"):
        ("rpn", "fpn_post_nms_top_n_train"),
    ("MODEL.RPN", "FPN_POST_NMS_TOP_N_TEST"):
        ("rpn", "fpn_post_nms_top_n_test"),
    ("MODEL.RPN", "RPN_SCALES_FROM_TOP"): ("rpn", "rpn_scales_from_top"),
    ("MODEL.RPN", "RPN_3D_2D_SELECTOR"): ("rpn", "rpn_3d_2d_selector"),
    ("MODEL.RPN", "ADD_GT_PROPOSALS"): ("rpn", "add_gt_proposals"),
    ("MODEL.LOSS", "YAW_MODE"): ("rpn", "yaw_loss_mode"),
    ("MODEL.ROI_HEADS", "FG_IOU_THRESHOLD"): ("roi", "fg_iou_threshold"),
    ("MODEL.ROI_HEADS", "BG_IOU_THRESHOLD"): ("roi", "bg_iou_threshold"),
    ("MODEL.ROI_HEADS", "BBOX_REG_WEIGHTS"): ("roi", "bbox_reg_weights"),
    ("MODEL.ROI_HEADS", "BATCH_SIZE_PER_IMAGE"): ("roi", "batch_size_per_image"),
    ("MODEL.ROI_HEADS", "POSITIVE_FRACTION"): ("roi", "positive_fraction"),
    ("MODEL.ROI_HEADS", "SCORE_THRESH"): ("roi", "score_thresh"),
    ("MODEL.ROI_HEADS", "NMS"): ("roi", "nms"),
    ("MODEL.ROI_HEADS", "NMS_AUG_THICKNESS_Y_Z"):
        ("roi", "nms_aug_thickness_y_z"),
    ("MODEL.ROI_HEADS", "DETECTIONS_PER_IMG"): ("roi", "detections_per_img"),
    ("MODEL.ROI_HEADS", "LABEL_AUG_THICKNESS_Y_TAR_ANC"):
        ("roi", "label_aug_thickness_y_tar_anc"),
    ("MODEL.ROI_HEADS", "LABEL_AUG_THICKNESS_Z_TAR_ANC"):
        ("roi", "label_aug_thickness_z_tar_anc"),
    ("MODEL.ROI_BOX_HEAD", "POOLER_RESOLUTION"): ("roi", "pooler_resolution"),
    ("MODEL.ROI_BOX_HEAD", "POOLER_SAMPLING_RATIO"):
        ("roi", "pooler_sampling_ratio"),
    ("MODEL.ROI_BOX_HEAD", "MLP_HEAD_DIM"): ("roi", "mlp_head_dim"),
    ("MODEL.ROI_BOX_HEAD", "CANONICAL_SIZE"): ("roi", "canonical_size"),
    ("MODEL.ROI_BOX_HEAD", "POOLER_SCALES_FROM_TOP"):
        ("roi", "pooler_scales_from_top"),
    ("SOLVER", "BASE_LR"): ("solver", "base_lr"),
    ("SOLVER", "BIAS_LR_FACTOR"): ("solver", "bias_lr_factor"),
    ("SOLVER", "MOMENTUM"): ("solver", "momentum"),
    ("SOLVER", "WEIGHT_DECAY"): ("solver", "weight_decay"),
    ("SOLVER", "WEIGHT_DECAY_BIAS"): ("solver", "weight_decay_bias"),
    ("SOLVER", "GAMMA"): ("solver", "gamma"),
    ("SOLVER", "LR_STEP_EPOCHS"): ("solver", "lr_step_epochs"),
    ("SOLVER", "WARMUP_FACTOR"): ("solver", "warmup_factor"),
    ("SOLVER", "WARMUP_EPOCHS"): ("solver", "warmup_epochs"),
    ("SOLVER", "WARMUP_METHOD"): ("solver", "warmup_method"),
    ("SOLVER", "EPOCHS"): ("solver", "epochs"),
    ("SOLVER", "EPOCHS_BETWEEN_TEST"): ("solver", "epochs_between_test"),
    ("SOLVER", "CHECKPOINT_PERIOD_EPOCHS"):
        ("solver", "checkpoint_period_epochs"),
    ("SOLVER", "IMS_PER_BATCH"): ("solver", "ims_per_batch"),
    ("SOLVER", "BN_MOMENTUM"): ("solver", "bn_momentum"),
    ("SOLVER", "TRACK_RUNNING_STATS"): ("solver", "track_running_stats"),
    ("TEST", "IMS_PER_BATCH"): ("test", "ims_per_batch"),
    ("TEST", "IOU_THRESHOLD"): ("test", "iou_threshold"),
    ("TEST", "EVAL_AUG_THICKNESS_Y_TAR_ANC"):
        ("test", "eval_aug_thickness_y_tar_anc"),
    ("TEST", "EVAL_AUG_THICKNESS_Z_TAR_ANC"):
        ("test", "eval_aug_thickness_z_tar_anc"),
    ("", "OUTPUT_DIR"): ("", "output_dir"),
    ("DEBUG", "eval_in_train"): ("", "eval_in_train"),
}


def _flatten(section_path, node, out):
    for k, v in node.items():
        if isinstance(v, dict):
            sub = f"{section_path}.{k}" if section_path else k
            _flatten(sub, v, out)
        else:
            out[(section_path, k)] = _parse_value(v)


def load_yaml_config(path, base: Config | None = None) -> Config:
    """``base`` (default ``Config()``) with the YAML file's known keys
    set; unknown keys outside DEBUG/DATALOADER/DATASETS warn."""
    base = base or Config()
    raw = _load_yaml(path) or {}
    flat = {}
    _flatten("", raw, flat)

    updates = {"": {}, "sparse3d": {}, "rpn": {}, "roi": {}, "solver": {},
               "test": {}}
    for key, value in flat.items():
        if key not in _MAPPING:
            if key[0] not in ("DEBUG", "DATALOADER", "DATASETS"):
                logger.warning("ignoring unknown config key %s", key)
            continue
        tree, fname = _MAPPING[key]
        updates[tree][fname] = _t(value)

    cfg = base
    for tree in ("sparse3d", "rpn", "roi", "solver", "test"):
        if updates[tree]:
            cfg = cfg.replace(**{tree: dataclasses.replace(
                getattr(cfg, tree), **updates[tree])})
    if updates[""]:
        cfg = cfg.replace(**updates[""])
    return cfg
