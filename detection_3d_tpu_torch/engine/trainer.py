"""Training engine: one optimizer step per building, and the epoch loop.

Counterpart of detection_3d_tpu/engine/trainer.py (reference
engine/trainer_sparse3d.py:42-172) for one device: per-step schedule,
the NaN gate (a step whose loss or any gradient is non-finite changes
nothing), bad-scene strikes and culling, windowed metric logging, the
min-loss checkpoint and periodic / final checkpoints.

A step runs pad -> voxelize_points -> forward with gt -> sum of the four
losses -> backward -> one fused isfinite over the loss and every
gradient -> SGD update when finite. The uniform draws of the two
samplers come from one ``torch.Generator`` on the device, seeded by
``train``'s seed. With ``cfg.eval_in_train`` = N, every N-th epoch
(epoch 0 included) pools each step's train-time detections and
evaluates them at the epoch's end (``Trainer.last_train_eval``).

Not ported yet: data parallelism over a mesh, and ``scan_steps``,
``train_resident`` and a ``.epoch()`` loader object as ``scenes``, which
need the host packers and the native loader.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from detection_3d_tpu_torch.config.defaults import Config
from detection_3d_tpu_torch.engine.solver import Solver
from detection_3d_tpu_torch.evaluation.detection_eval import (
    eval_aug_thickness, evaluate_detections,
)
from detection_3d_tpu_torch.models.detector import SparseRCNN, voxelize_points
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.utils.checkpoint import Checkpointer
from detection_3d_tpu_torch.utils.device import resolve_device
from detection_3d_tpu_torch.utils.metric_logger import MetricLogger

_LOG = logging.getLogger(__name__)


def pad_scene(cfg: Config, scene: Dict) -> Dict[str, np.ndarray]:
    """Host-side: pad a scene dict to the static capacities, warning when
    points or gt boxes exceed them (silent loss of input is never
    acceptable)."""
    n = cfg.caps.max_points
    pts = np.zeros((n, 3), np.float32)
    fts = np.zeros((n, cfg.in_channels), np.float32)
    m = min(scene["points"].shape[0], n)
    if scene["points"].shape[0] > n:
        _LOG.warning(
            "pad_scene: %d points exceed caps.max_points=%d — dropping "
            "%.1f%% of the input (raise caps.max_points)",
            scene["points"].shape[0], n,
            100.0 * (1 - n / scene["points"].shape[0]))
    pts[:m] = scene["points"][:m]
    fts[:m] = scene["feats"][:m, :cfg.in_channels]
    pvalid = np.arange(n) < m

    g = cfg.caps.max_gt
    gtb = np.zeros((g, 7), np.float32)
    gtb[:, 3:6] = 0.1  # harmless nonzero sizes on padding rows
    gtl = np.zeros((g,), np.int32)
    mg = min(scene["gt_boxes"].shape[0], g)
    gtb[:mg] = scene["gt_boxes"][:mg]
    gtl[:mg] = scene["gt_labels"][:mg]
    gvalid = np.arange(g) < mg
    if scene["gt_boxes"].shape[0] > g:
        _LOG.warning(
            "pad_scene: %d gt boxes exceed caps.max_gt=%d — dropping %d "
            "targets (raise caps.max_gt)",
            scene["gt_boxes"].shape[0], g, scene["gt_boxes"].shape[0] - g)
    return {"points": pts, "feats": fts, "points_valid": pvalid,
            "gt_boxes": gtb, "gt_labels": gtl, "gt_valid": gvalid}


def batch_to_device(batch: Dict[str, np.ndarray], dev):
    """((points, feats, points_valid), gt Boxes3D, gt labels) of a padded
    batch, on ``dev``."""
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    return (b["points"], b["feats"], b["points_valid"]), \
        Boxes3D(b["gt_boxes"], b["gt_valid"]), b["gt_labels"]


def check_capacities(cfg: Config, scene: Dict, logger=None, device="cuda"):
    """Build the voxel pyramid of one scene and report per-scale true
    voxel counts against the configured capacities, warning where the
    input layer subsampled. Returns a list of (true_num, capacity)."""
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    dev = resolve_device(device)
    (pts, fts, valid), _, _ = batch_to_device(pad_scene(cfg, scene), dev)
    pyr = build_pyramid(voxelize_points(cfg, pts, fts, valid), cfg)
    out = []
    for k, t in enumerate(pyr["tables"]):
        tn, cap = int(t.true_num), t.capacity
        out.append((tn, cap))
        if tn > cap and logger:
            logger.warning(
                "scale %d: %d active voxels exceed capacity %d "
                "(subsampled %.0f%%) — raise caps.voxel_caps[%d]",
                k, tn, cap, 100.0 * (1 - cap / tn), k)
    return out


def cycle_pad(order: list, k: int) -> list:
    """Pad ``order`` to a multiple of ``k`` by cycling it (correct even
    when the pad exceeds len(order))."""
    if len(order) % k:
        pad = k - len(order) % k
        order = order + (order * (pad // len(order) + 1))[:pad]
    return order


@dataclass
class TrainState:
    """The model (its parameters), the solver (momentum and schedule
    clock) and the number of steps taken, applied or skipped."""
    model: SparseRCNN
    solver: Solver
    step: int = 0

    def state_dict(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.solver.state_dict(), "step": self.step}

    def load_state_dict(self, state):
        self.model.load_state_dict(state["model"])
        self.solver.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def total_loss(losses: Dict[str, torch.Tensor]):
    """Sum of the loss dict in key order (the JAX trainer sums its leaves
    in sorted-key order)."""
    return sum(losses[k] for k in sorted(losses))


def grads_finite(total, params) -> bool:
    """One fused isfinite over the loss and every gradient (None counts
    as zero)."""
    grads = [p.grad.reshape(-1) for p in params if p.grad is not None]
    flat = torch.cat([total.detach().reshape(1).to(torch.float32)]
                     + [g.to(torch.float32) for g in grads])
    return bool(torch.isfinite(flat).all())


class Trainer:
    """Single-device training loop (on the card unless ``device`` says
    the CPU; asking for the card without one raises)."""

    def __init__(self, cfg: Config, output_dir: Optional[str] = None,
                 logger=None, device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel training over a mesh is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = logger
        self.output_dir = output_dir or cfg.output_dir
        self.checkpointer = Checkpointer(self.output_dir, logger)
        self.meters = MetricLogger()
        self.min_loss = float("inf")
        self.min_save_every = 50
        self._last_min_save = -(10 ** 9)
        # non-finite steps a scene may contribute before it is culled
        # from the rotation (reference: curated SceneSamples.bad_scenes)
        self.bad_scene_strikes = 3
        self.scan_steps = 1
        self.history = []
        # eval_in_train: the last step's train-time detections (numpy,
        # valid rows) and the last evaluated epoch's DetectionEvalResult
        self.last_detections = None
        self.last_train_eval = None

    def init_state(self, example_scene: Optional[Dict] = None,
                   seed: int = 0, iters_per_epoch: int = 1,
                   model: Optional[SparseRCNN] = None) -> TrainState:
        """A fresh state: ``model`` (moved to the device) or a
        SparseRCNN drawn from ``seed``; the example scene is not needed
        (the port's modules know their shapes) and is accepted for the
        JAX trainer's signature."""
        model = (model if model is not None
                 else SparseRCNN(self.cfg, seed=seed)).to(self.device)
        model.train()
        return TrainState(model, Solver(self.cfg, model, iters_per_epoch))

    def train_resident(self, *args, **kwargs):
        raise NotImplementedError(
            "train_resident needs the host pyramid packer, which is not "
            "ported yet")

    def _persist_bad_scenes(self, names):
        """Write the culled blocklist to <output_dir>/bad_scenes.json."""
        path = os.path.join(self.output_dir, "bad_scenes.json")
        os.makedirs(self.output_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(sorted(names), f)

    def step(self, state: TrainState, batch: Dict[str, np.ndarray],
             generator: Optional[torch.Generator] = None, priorities=None):
        """One training step on a padded batch. Returns (total, losses,
        ok, true_num) as host numbers; the update is applied only when
        ``ok`` (finite loss and gradients). With ``cfg.eval_in_train``,
        ``self.last_detections`` holds the step's train-time detections
        ({boxes, scores, labels} of the valid rows, numpy)."""
        (pts, fts, valid), gt, gt_labels = batch_to_device(batch,
                                                           self.device)
        table = voxelize_points(self.cfg, pts, fts, valid)
        state.solver.zero_grad()
        losses = state.model(table, gt, gt_labels, generator=generator,
                             priorities=priorities)
        if self.cfg.eval_in_train:
            losses, dets = losses
            v = dets.valid.cpu().numpy()
            self.last_detections = {
                "boxes": dets.boxes.cpu().numpy()[v],
                "scores": dets.fields["scores"].cpu().numpy()[v],
                "labels": dets.fields["labels"].cpu().numpy()[v]}
        total = total_loss(losses)
        total.backward()
        ok = grads_finite(total, state.solver.params)
        if ok:
            state.solver.apply()
        state.step += 1
        return (float(total.detach()),
                {k: float(v.detach()) for k, v in losses.items()}, ok,
                int(table.true_num))

    def _save(self, name, state: TrainState):
        self.checkpointer.save(name, state.state_dict())

    def train(self, scenes, state: TrainState, epochs: int, seed: int = 0,
              checkpoint_period_epochs: Optional[int] = None):
        """``epochs`` passes over ``scenes`` (a list of scene dicts), in a
        fresh shuffle each epoch, one building per step. Returns the
        state; ``self.history`` holds one (total, losses, ok, seconds)
        per step, the seconds on the host clock (each step ends with the
        losses on the host, so the clock covers its device work). An
        eval-in-train epoch's result lands in ``self.last_train_eval``."""
        cfg = self.cfg
        if self.scan_steps != 1:
            raise NotImplementedError(
                "scan_steps > 1 is not ported (it needs the host packer)")
        if hasattr(scenes, "epoch"):
            raise NotImplementedError(
                "loader objects are not ported yet: pass a list of scene "
                "dicts")
        scenes = list(scenes)
        n_scenes = len(scenes)
        ckpt_period = checkpoint_period_epochs or \
            cfg.solver.checkpoint_period_epochs
        gen = torch.Generator(device=self.device).manual_seed(seed + 123)
        shuffle_rng = np.random.default_rng(seed + 77)
        cap0 = cfg.caps.scale_caps(cfg.sparse3d.num_scales)[0]
        strikes = np.zeros(n_scenes, np.int64)
        culled: set = set()
        culled_names: list = []
        self.history = []
        state.model.train()
        it = 0
        t_start = time.time()
        for epoch in range(epochs):
            # eval-in-train (JAX trainer.py:546-548, reference
            # trainer_sparse3d.py:95-104,165-172): pool this epoch's
            # train-time detections and evaluate them at its end
            eval_this_epoch = (cfg.eval_in_train > 0
                               and epoch % cfg.eval_in_train == 0)
            epoch_preds, epoch_gts = [], []
            order = [i for i in shuffle_rng.permutation(n_scenes)
                     if i not in culled]
            if not order:
                raise RuntimeError(
                    "trainer: every scene was culled as bad "
                    f"({len(culled)} scenes with >= "
                    f"{self.bad_scene_strikes} non-finite steps)")
            for si in order:
                batch = pad_scene(cfg, scenes[si])
                t0 = time.perf_counter()
                total, losses, ok, true_num = self.step(state, batch, gen)
                dt = time.perf_counter() - t0
                self.history.append((total, losses, ok, dt))
                if eval_this_epoch:
                    epoch_preds.append(self.last_detections)
                    epoch_gts.append({"boxes": scenes[si]["gt_boxes"],
                                      "labels": scenes[si]["gt_labels"]})
                if true_num > cap0 and self.logger:
                    self.logger.warning(
                        "iter %d: %d voxels exceed scale-0 capacity %d — "
                        "input subsampled (raise caps)", it, true_num, cap0)
                self.meters.update(loss=total, time=dt, **losses)
                if not ok:
                    self._strike(si, scenes, strikes, culled, culled_names,
                                 it)
                if self.logger and it % 20 == 0:
                    eta = (time.time() - t_start) / (it + 1) * \
                        (epochs * n_scenes - it - 1)
                    self.logger.info(
                        "iter %d epoch %d eta %.0fs lr %.5f %s", it, epoch,
                        eta, state.solver.lr(state.solver.count),
                        self.meters)
                # min-loss checkpoint: track the minimum every step, write
                # at most once per min_save_every steps
                if np.isfinite(total) and total < self.min_loss:
                    self.min_loss = total
                    if it - self._last_min_save >= self.min_save_every:
                        self._last_min_save = it
                        self._save("model_min_loss", state)
                it += 1
            if eval_this_epoch and epoch_preds:
                self._evaluate_epoch(epoch, epoch_preds, epoch_gts)
            if (epoch + 1) % ckpt_period == 0:
                self._save(f"model_{epoch:07d}", state)
        self._save("model_final", state)
        return state

    def _evaluate_epoch(self, epoch, preds, gts):
        """Evaluate an epoch's train-time detections on the trainer's
        device into ``self.last_train_eval`` and log the summary."""
        cfg = self.cfg
        self.last_train_eval = evaluate_detections(
            preds, gts, cfg.num_classes, cfg.test.iou_threshold,
            eval_aug_thickness=eval_aug_thickness(cfg),
            class_names=cfg.ordered_class_names(), device=self.device)
        if self.logger:
            self.logger.info("eval-in-train epoch %d:\n%s", epoch,
                             self.last_train_eval.summary())

    def _strike(self, si, scenes, strikes, culled, culled_names, it):
        """Count a non-finite step against its scene; cull the scene from
        the rotation at ``bad_scene_strikes`` and persist the list."""
        if self.logger:
            self.logger.warning("non-finite loss at iter %d; update "
                                "skipped", it)
        strikes[si] += 1
        if strikes[si] < self.bad_scene_strikes or si in culled:
            return
        culled.add(si)
        name = str(scenes[si].get("scene_name", si))
        culled_names.append(name)
        self._persist_bad_scenes(culled_names)
        if self.logger:
            self.logger.warning(
                "scene %s culled after %d non-finite steps (%d/%d scenes "
                "culled)", name, strikes[si], len(culled), len(scenes))
