"""SUNCG/SYNBIM dataset: loads reference-format house ``.pth`` files.

A copy of detection_3d_tpu/data/suncg.py (reference
data3d/suncg_utils/suncg_dataset.py:24-206): each house file holds
``(pcl (N,9) [xyz,color,normal], bboxes_dic class->(M,7) standard
boxes)``. Per item:
  * select configured classes; convert gt to yx_zb; zero yaw for
    ceiling/floor/room (set_yaw_zero semantics);
  * scale xyz by voxel_scale, shift min to 0; same offset applied to gt
    centers (in meters);
  * drop out-of-grid points;
  * labels assigned by canonical class order (data/dataset_metas.py).

Output is the plain scene dict (points/feats/gt_boxes/gt_labels as
numpy) that ``pad_scene`` takes. The house files are pickles (numpy
arrays in a tuple and a dict, which ``weights_only`` loading refuses),
so read only houses from a trusted source.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.data.dataset_metas import DatasetMetas
from detection_3d_tpu_torch.data.synthetic import standard_to_yx_zb_np

ELEMENTS_IDS = {"xyz": [0, 1, 2], "color": [3, 4, 5], "normal": [6, 7, 8]}


def _set_yaw_zero(boxes_yx_zb):
    """For symmetric classes (ceiling/floor/room): yaw must be a multiple
    of pi/2; swap sizes for odd multiples and zero the yaw
    (bbox3d_ops.py:178-195, applied post-conversion as in
    suncg_dataset.py:105-109)."""
    if boxes_yx_zb.shape[0] == 0:
        return boxes_yx_zb
    b = boxes_yx_zb.copy()
    yaws = b[:, 6]
    switch = np.abs(np.round(yaws / (np.pi / 2))).astype(int) % 2
    sy = b[:, 3] * (1 - switch) + b[:, 4] * switch
    sx = b[:, 4] * (1 - switch) + b[:, 3] * switch
    b[:, 3] = sy
    b[:, 4] = sx
    b[:, 6] = 0.0
    return b


def rm_bad_samples(scene_names: List[str],
                   bad_scenes_path: Optional[str] = None) -> List[str]:
    """Filter known-bad scenes from a scene list: the blocklist is a JSON
    list file, curated by hand and/or written by the Trainer's
    strike-based bad-scene culling (reference rm_bad_samples +
    SceneSamples.bad_scenes, suncg_dataset.py:272-277)."""
    bad: set = set()
    if bad_scenes_path and os.path.exists(bad_scenes_path):
        with open(bad_scenes_path) as f:
            bad = set(json.load(f))
    return [s for s in scene_names if s not in bad]


class SUNCGDataset:
    """The houses of one split under ``data_root`` (default
    ``$SUNCG_TORCH_PATH``): ``train_test_splited/<split>.txt`` names the
    scenes (unless ``cfg.scenes`` does), ``houses/<scene>/*.pth`` holds
    their files, and ``bad_scenes.json`` lists scenes to skip."""

    def __init__(self, split: str, cfg: Config,
                 data_root: Optional[str] = None):
        self.cfg = cfg
        self.metas = DatasetMetas(cfg.classes)
        self.scale = cfg.sparse3d.voxel_scale
        self.full_scale = np.array(cfg.sparse3d.voxel_full_scale)
        root = data_root or os.environ.get("SUNCG_TORCH_PATH", "")
        self.files: List[str] = []
        if root:
            split_file = os.path.join(root, "train_test_splited",
                                      f"{split}.txt")
            scenes = list(cfg.scenes)
            if not scenes and os.path.exists(split_file):
                with open(split_file) as f:
                    scenes = [l.strip() for l in f if l.strip()]
            scenes = rm_bad_samples(
                scenes, os.path.join(root, "bad_scenes.json"))
            for scene in scenes:
                self.files += sorted(
                    glob.glob(os.path.join(root, "houses", scene, "*.pth")))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        pcl, bboxes_dic = torch.load(self.files[index],
                                     map_location="cpu", weights_only=False)
        pcl = np.asarray(pcl, np.float32)
        return self.prepare_scene(pcl, {
            k: np.asarray(v, np.float32) for k, v in bboxes_dic.items()})

    def prepare_scene(self, pcl: np.ndarray,
                      bboxes_dic: Dict[str, np.ndarray]):
        """pcl (N, 9); bboxes_dic class -> (M, 7) STANDARD boxes."""
        cfg = self.cfg
        xyz = pcl[:, :3].copy()

        boxes_all, labels_all = [], []
        for obj, boxes in bboxes_dic.items():
            if obj not in self.metas.class_2_label:
                continue
            if boxes.shape[0] == 0:
                continue
            yx = standard_to_yx_zb_np(boxes).astype(np.float32)
            if obj in ("ceiling", "floor", "room"):
                yx = _set_yaw_zero(yx)
            boxes_all.append(yx)
            labels_all.append(np.full(yx.shape[0],
                                      self.metas.class_2_label[obj],
                                      np.int32))
        gt_boxes = (np.concatenate(boxes_all, 0) if boxes_all
                    else np.zeros((0, 7), np.float32))
        gt_labels = (np.concatenate(labels_all, 0) if labels_all
                     else np.zeros((0,), np.int32))

        # scale + shift to positive octant (suncg_dataset.py:115-137)
        a = xyz * self.scale
        offset = -a.min(0)
        a = a + offset
        gt_boxes = gt_boxes.copy()
        gt_boxes[:, :3] += offset[None, :] / self.scale

        # element selection for features
        ids = np.array([ELEMENTS_IDS[e] for e in cfg.elements]).reshape(-1)
        ids.sort()
        feats = pcl[:, ids].copy()
        if "xyz" in cfg.elements:
            feats[:, 0:3] = a / self.scale

        # drop out-of-grid points (suncg_dataset.py:160-171)
        keep = np.all((a >= 0) & (a < self.full_scale[None, :]), axis=1)
        return {"points": a[keep].astype(np.float32),
                "feats": feats[keep].astype(np.float32),
                "gt_boxes": gt_boxes.astype(np.float32),
                "gt_labels": gt_labels}

    def get_groundtruth(self, index: int):
        s = self[index]
        return {"boxes": s["gt_boxes"], "labels": s["gt_labels"]}
