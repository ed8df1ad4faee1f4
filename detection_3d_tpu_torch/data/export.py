"""Prediction export: per-room text files of standard boxes + label.

The port's copy of detection_3d_tpu/data/export.py, over the port's
ops/geometry.yx_zb_to_standard.

Parity with the reference data3d/pth_to_txt.py:6-24: each room's
detections (yx_zb) convert to standard format and save as rows of
``[xc, yc, zc, x_size, y_size, z_size, yaw, label]``.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from detection_3d_tpu_torch.ops.geometry import yx_zb_to_standard


def predictions_to_txt(predictions: List[Dict], out_dir: str):
    """predictions: per-room {boxes (N,7) yx_zb, labels (N,)}."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, pred in enumerate(predictions):
        boxes = np.asarray(pred["boxes"], np.float32)
        labels = np.asarray(pred["labels"]).reshape(-1, 1)
        std = yx_zb_to_standard(torch.from_numpy(boxes)).numpy()
        room = np.concatenate([std, labels.astype(std.dtype)], axis=1)
        path = os.path.join(out_dir, f"room_{i}.txt")
        np.savetxt(path, room)
        paths.append(path)
    return paths
