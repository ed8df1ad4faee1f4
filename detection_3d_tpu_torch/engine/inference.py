"""Inference engine: per-building predict and a sequential serving loop.

Counterpart of detection_3d_tpu/engine/inference.py for the raw input
form (``packed=False``): a building's padded point arrays go in, one
packed (K, 10) f32 array ``[boxes7 | score | label | valid]`` plus the
input layer's ``true_num`` come out; ``run_inference(evaluate=True)``
then scores the detections against the scenes' gt with
evaluation/detection_eval.py. The host packers and the pipelined loop
are not ported yet.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.engine.trainer import pad_scene  # noqa: F401
from detection_3d_tpu_torch.evaluation.detection_eval import (
    eval_aug_thickness, evaluate_detections,
)
from detection_3d_tpu_torch.models.detector import SparseRCNN, voxelize_points
from detection_3d_tpu_torch.utils.device import resolve_device

_LOG = logging.getLogger(__name__)


def make_predict_fn(cfg: Config, model: Optional[SparseRCNN] = None,
                    device="cuda"):
    """Per-building predict on ``device`` (the card unless the caller
    asks for the CPU; raises when CUDA is asked for and absent).

    Returns ``predict(batch, phases=None) -> (packed_out, true_num)``:
    ``batch`` is a :func:`pad_scene` dict, ``packed_out`` a (K, 10) f32
    tensor ``[boxes7 | score | label | valid]`` and ``true_num`` the
    pre-truncation voxel count, both on ``device``. ``phases`` is an
    optional utils/timing.PhaseTimer.
    """
    dev = resolve_device(device)
    model = (model if model is not None else SparseRCNN(cfg)).to(dev).eval()

    @torch.inference_mode()
    def predict(batch, phases=None):
        pts, fts, valid = (torch.as_tensor(batch[k]).to(dev)
                           for k in ("points", "feats", "points_valid"))
        table = voxelize_points(cfg, pts, fts, valid)
        det = model(table, phases=phases)
        packed_out = torch.cat(
            [det.boxes, det.fields["scores"][:, None],
             det.fields["labels"].to(torch.float32)[:, None],
             det.valid.to(torch.float32)[:, None]], -1)
        return packed_out, table.true_num

    return predict


def run_inference(cfg: Config, model: Optional[SparseRCNN],
                  scenes: Iterable[Dict], device="cuda",
                  evaluate: bool = False, predict_fn=None, logger=None):
    """Answer a list of buildings one after another.

    Returns (predictions, result, seconds_per_building): one
    {"boxes", "scores", "labels", "true_num"} dict per building (numpy,
    valid rows only); the time is the host clock from the padded arrays
    to the detections on the host, averaged over every building after
    the first. With ``evaluate`` (off by default, unlike the JAX
    package's run_inference), ``result`` is the DetectionEvalResult of
    the detections against the scenes' ``gt_boxes``/``gt_labels``, its
    IoUs computed on ``device`` after the timed loop; else None.
    ``logger`` gets the capacity warnings and, with ``evaluate``, the
    summary.
    """
    log = logger or _LOG
    scenes = list(scenes)
    predict = predict_fn or make_predict_fn(cfg, model, device)
    cap0 = cfg.caps.scale_caps(cfg.sparse3d.num_scales)[0]
    preds, total_t, n_timed = [], 0.0, 0
    for i, scene in enumerate(scenes):
        batch = pad_scene(cfg, scene)
        t0 = time.perf_counter()
        packed_out, true_num = predict(batch)
        a = packed_out.cpu().numpy()
        true_num = int(true_num)
        dt = time.perf_counter() - t0
        if i > 0:    # the first building warms up allocator and kernels
            total_t += dt
            n_timed += 1
        if true_num > cap0:
            log.warning(
                "scene %d: %d voxels exceed the scale-0 capacity %d — "
                "input subsampled (raise caps.voxel_caps / max_points)",
                i, true_num, cap0)
        v = a[:, 9] > 0.5
        preds.append({"boxes": a[v, :7], "scores": a[v, 7],
                      "labels": a[v, 8].astype(np.int32),
                      "true_num": true_num})
    sec_per_building = total_t / max(n_timed, 1)
    result = None
    if evaluate:
        gts = [{"boxes": s["gt_boxes"], "labels": s["gt_labels"]}
               for s in scenes]
        result = evaluate_detections(
            preds, gts, cfg.num_classes, cfg.test.iou_threshold,
            eval_aug_thickness=eval_aug_thickness(cfg),
            class_names=cfg.ordered_class_names(), device=device)
        if logger:
            logger.info("\n%s", result.summary())
            logger.info("sec/building: %.3f", sec_per_building)
    return preds, result, sec_per_building
