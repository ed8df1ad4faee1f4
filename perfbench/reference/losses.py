"""Detection losses: smooth-L1 with yaw modes, masked BCE and CE.

Counterpart of detection_3d_tpu/models/losses.py (reference
layers/smooth_l1_loss.py:15-49, loss_3d.py:237-248 and
box_head_3d/loss.py:196-237). Every reduction is masked: padded rows
contribute zero.
"""

from __future__ import annotations

import math

import torch


def yaw_loss(pred, target, anchor_yaw, mode: str = "Diff"):
    """(N,) yaw-column loss of the yaw offsets: |diff| ('Diff'), or
    sin|diff| where the predicted yaw stays in [-pi/2, pi/2] and |diff|
    elsewhere ('SinDiff'), times an optional '_<weight>' suffix."""
    parts = mode.split("_")
    base = parts[0]
    weight = float(parts[1]) if len(parts) == 2 else 1.0
    dif = torch.abs(pred - target)
    if base == "Diff":
        return dif
    if base != "SinDiff":
        raise ValueError(f"yaw_loss_mode {mode!r}: expected Diff or SinDiff")
    in_scope = torch.abs(pred + anchor_yaw) <= math.pi / 2
    return torch.where(in_scope, torch.sin(dif), dif) * weight


def smooth_l1_box_loss(pred, target, anchors, mask, beta: float,
                       yaw_loss_mode: str = "Diff"):
    """Masked sum of per-row smooth-L1 over the 7 box dims; (N, 7)
    pred / target / anchors, (N,) mask."""
    dif = torch.abs(pred - target)
    yl = yaw_loss(pred[:, 6], target[:, 6], anchors[:, 6], yaw_loss_mode)
    dif = torch.cat([dif[:, :6], yl[:, None]], -1)
    loss = torch.where(dif < beta, 0.5 * dif * dif / beta, dif - 0.5 * beta)
    return torch.where(mask[:, None], loss, 0.0).sum()


def _count(mask):
    return torch.clamp(mask.to(torch.float32).sum(), min=1.0)


def bce_with_logits(logits, labels, mask):
    """Masked mean binary cross-entropy."""
    # torch.maximum, not clamp: at a tie its gradient splits in halves,
    # as jnp.maximum's does
    per = torch.maximum(logits, torch.zeros_like(logits)) \
        - logits * labels + torch.log1p(torch.exp(-torch.abs(logits)))
    return torch.where(mask, per, 0.0).sum() / _count(mask)


def cross_entropy(logits, labels, mask):
    """Masked mean CE; labels (N,) int, rows outside ``mask`` ignored."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, 1, torch.clamp(labels, min=0).to(
        torch.int64)[:, None])[:, 0]
    return -torch.where(mask, ll, 0.0).sum() / _count(mask)
