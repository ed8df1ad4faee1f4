"""Masked batch norm + leaky ReLU over active sparse rows.

Counterpart of detection_3d_tpu/ops/norm.py. The reference configs run
TRACK_RUNNING_STATS=False, so batch statistics are used in eval too;
statistics are taken over valid rows only, eps is 1e-4, and invalid rows
come out zero.
"""

from __future__ import annotations

import torch


def batch_norm_leaky_relu(feats, valid, scale, bias, leakiness: float = 0.0,
                          eps: float = 1e-4):
    """feats (V, C); valid (V,) bool; scale/bias (C,). Statistics and the
    normalisation run in f32; the output is in feats.dtype."""
    f32 = feats.to(torch.float32)
    w = valid.to(torch.float32)[:, None]
    n = torch.clamp(w.sum(), min=1.0)
    mean = (f32 * w).sum(0) / n
    var = (f32.square() * w).sum(0) / n - mean.square()
    # torch.maximum: at a tie its gradient splits in halves, as
    # jnp.maximum's does (clamp would pass all of it)
    var = torch.maximum(var, torch.zeros_like(var))
    inv = torch.reciprocal(torch.sqrt(var + eps))
    out = (f32 - mean) * (inv * scale) + bias
    out = torch.where(out > 0, out, out * leakiness)
    out = torch.where(valid[:, None], out, 0.0)
    return out.to(feats.dtype)
