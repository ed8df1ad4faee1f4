"""The reference's training step: a plain statement of one step of the
port's trainer (pad, voxelize, the forward with gt, the sum of the
losses in key order, backward, one isfinite over the loss and every
gradient, the SGD update applied where it holds), on the reference's own
model and solver, in float32."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench.reference.detector import voxelize_points
from perfbench.reference.solver import Solver
from perfbench.reference.structures import Boxes3D


def pad_scene(cfg, scene: Dict) -> Dict[str, np.ndarray]:
    """A building's points and gt boxes padded to the configuration's
    capacities (pad rows of gt get sizes 0.1 and label 0)."""
    n, g = cfg.caps.max_points, cfg.caps.max_gt
    m = min(scene["points"].shape[0], n)
    pts = np.zeros((n, 3), np.float32)
    fts = np.zeros((n, cfg.in_channels), np.float32)
    pts[:m] = scene["points"][:m]
    fts[:m] = scene["feats"][:m, :cfg.in_channels]
    mg = min(scene["gt_boxes"].shape[0], g)
    gtb = np.zeros((g, 7), np.float32)
    gtb[:, 3:6] = 0.1
    gtl = np.zeros((g,), np.int32)
    gtb[:mg] = scene["gt_boxes"][:mg]
    gtl[:mg] = scene["gt_labels"][:mg]
    return {"points": pts, "feats": fts, "points_valid": np.arange(n) < m,
            "gt_boxes": gtb, "gt_labels": gtl,
            "gt_valid": np.arange(g) < mg}


def step(cfg, model, solver: Solver, padded: Dict, priorities: Dict,
         device) -> Dict[str, float]:
    """One gated training step; returns the losses (host numbers)."""
    b = {k: torch.as_tensor(v).to(device) for k, v in padded.items()}
    solver.zero_grad()
    table = voxelize_points(cfg, b["points"], b["feats"], b["points_valid"])
    losses = model(table, Boxes3D(b["gt_boxes"], b["gt_valid"]),
                   b["gt_labels"], priorities=priorities)
    total = sum(losses[k] for k in sorted(losses))
    total.backward()
    flat = [total.detach().reshape(1)] + [p.grad.reshape(-1).float()
                                           for p in solver.params
                                           if p.grad is not None]
    solver.apply(torch.isfinite(torch.cat(flat)).all())
    return {k: float(v.detach()) for k, v in losses.items()}
