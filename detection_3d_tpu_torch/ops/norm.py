"""Masked batch norm + leaky ReLU over active sparse rows.

Counterpart of detection_3d_tpu/ops/norm.py. The reference configs run
TRACK_RUNNING_STATS=False, so batch statistics are used in eval too;
statistics are taken over valid rows only, eps is 1e-4, and invalid rows
come out zero. A unit of B buildings (feats (B, V, C)) normalises each
building with its own statistics, as a vmap over buildings does. The
sums over the rows run in a fixed tree (:func:`rows_sum`), so a
building's statistics are the same bits in a unit as alone. With a ``process_group`` (a voxel set spatially sharded
over ranks, parallel/spatial.py) the row count and the two moment sums
are summed over the group first, so every shard normalises with the
global statistics (JAX's ``axis_name`` psum).
"""

from __future__ import annotations

import torch

from detection_3d_tpu_torch.parallel.collectives import all_reduce_sum


ROWS_CHUNK = 16


def rows_sum(x):
    """Sum of (..., V, C) over its V rows in a fixed tree: chunks of
    ROWS_CHUNK consecutive rows (zero-padded), then chunks of those
    sums, until one is left. Each leading index takes the same order
    whatever the leading shape is; one reduction over a (B, V, C) tensor
    splits its V rows among the card's blocks by the number of outputs,
    so a building's sums would change bits with B."""
    while x.shape[-2] > 1:
        pad = (-x.shape[-2]) % ROWS_CHUNK
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-2]
                                          + (pad, x.shape[-1]))], -2)
        x = x.reshape(x.shape[:-2] + (-1, ROWS_CHUNK, x.shape[-1])).sum(-2)
    return x[..., 0, :]


def batch_norm_leaky_relu(feats, valid, scale, bias, leakiness: float = 0.0,
                          eps: float = 1e-4, process_group=None):
    """feats (..., V, C); valid (..., V) bool; scale/bias (C,). Statistics
    over each leading index's V rows; they and the normalisation run in
    f32; the output is in feats.dtype. ``process_group`` (one building's
    (V, C) rows): sum (n, sum x, sum x^2) over its ranks (a
    differentiable all-reduce) before the moments are taken."""
    f32 = feats.to(torch.float32)
    w = valid.to(torch.float32)[..., None]
    c = f32.shape[-1]
    sums = rows_sum(torch.cat([w, f32 * w, f32.square() * w], -1))
    n, s1, s2 = sums[..., :1], sums[..., 1:1 + c], sums[..., 1 + c:]
    if process_group is not None:
        sums = all_reduce_sum(sums, process_group)
        n, s1, s2 = sums[:1], sums[1:1 + c], sums[1 + c:]
    n = torch.clamp(n, min=1.0)
    mean = s1 / n
    var = s2 / n - mean.square()
    # torch.maximum: at a tie its gradient splits in halves, as
    # jnp.maximum's does (clamp would pass all of it)
    var = torch.maximum(var, torch.zeros_like(var))
    inv = torch.reciprocal(torch.sqrt(var + eps))
    out = (f32 - mean[..., None, :]) * (inv * scale)[..., None, :] + bias
    if leakiness != 1.0:    # slope 1: BN alone
        out = torch.where(out > 0, out, out * leakiness)
    out = torch.where(valid[..., None], out, 0.0)
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
