"""Masked batch norm + leaky ReLU over active sparse rows.

Counterpart of detection_3d_tpu/ops/norm.py. The reference configs run
TRACK_RUNNING_STATS=False, so batch statistics are used in eval too;
statistics are taken over valid rows only, eps is 1e-4, and invalid rows
come out zero. With a ``process_group`` (a voxel set spatially sharded
over ranks, parallel/spatial.py) the row count and the two moment sums
are summed over the group first, so every shard normalises with the
global statistics (JAX's ``axis_name`` psum).
"""

from __future__ import annotations

import torch

from detection_3d_tpu_torch.parallel.collectives import all_reduce_sum


def batch_norm_leaky_relu(feats, valid, scale, bias, leakiness: float = 0.0,
                          eps: float = 1e-4, process_group=None):
    """feats (V, C); valid (V,) bool; scale/bias (C,). Statistics and the
    normalisation run in f32; the output is in feats.dtype.
    ``process_group``: sum (n, sum x, sum x^2) over its ranks (a
    differentiable all-reduce) before the moments are taken."""
    f32 = feats.to(torch.float32)
    w = valid.to(torch.float32)[:, None]
    n, s1, s2 = w.sum(), (f32 * w).sum(0), (f32.square() * w).sum(0)
    if process_group is not None:
        c = s1.shape[0]
        sums = all_reduce_sum(torch.cat([n.reshape(1), s1, s2]),
                              process_group)
        n, s1, s2 = sums[0], sums[1:1 + c], sums[1 + c:]
    n = torch.clamp(n, min=1.0)
    mean = s1 / n
    var = s2 / n - mean.square()
    # torch.maximum: at a tie its gradient splits in halves, as
    # jnp.maximum's does (clamp would pass all of it)
    var = torch.maximum(var, torch.zeros_like(var))
    inv = torch.reciprocal(torch.sqrt(var + eps))
    out = (f32 - mean) * (inv * scale) + bias
    out = torch.where(out > 0, out, out * leakiness)
    out = torch.where(valid[:, None], out, 0.0)
    return out.to(feats.dtype)


def batch_stats(feats, valid):
    """Masked (mean, var) over the valid rows, f32, for keeping running
    statistics (JAX ops/norm.py:51); the variance is taken about the
    mean, as JAX takes it."""
    f32 = feats.to(torch.float32)
    w = valid.to(torch.float32)[:, None]
    n = torch.clamp(w.sum(), min=1.0)
    mean = (f32 * w).sum(0) / n
    var = ((f32 - mean).square() * w).sum(0) / n
    return mean, var
