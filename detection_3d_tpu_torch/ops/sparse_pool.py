"""Sparse pooling and unpooling over rulebooks.

Counterpart of detection_3d_tpu/ops/sparse_pool.py (SCN's MaxPooling,
AveragePooling and UnPooling): pool over a strided-conv rulebook (the
output table of a strided conv), unpool by gathering each fine site's
parent over a deconv rulebook. The detector does not use them; the
generic networks of models/factories.py do.

The JAX package folds the K offsets with ``lax.scan`` outside any Pallas
kernel, so these are plain PyTorch on every device: a gather per offset
with an f32 running maximum, or a running sum and count. Offsets are
folded in order 0..K-1, as the scan folds them, so sums round alike and
a tied maximum routes its gradient alike: ``torch.maximum``, like
``jnp.maximum``, gives half to each side of a tie, so among equal inputs
the last offset takes 1/2, the one before 1/4, and so on.
"""

from __future__ import annotations

import torch


def _with_pad_row(feats, fill: float):
    """(V, C) -> (V + 1, C) f32, row V = ``fill`` (what a missing entry,
    index V, reads)."""
    pad = torch.full((1, feats.shape[-1]), fill, dtype=torch.float32,
                     device=feats.device)
    return torch.cat([feats.to(torch.float32), pad], 0)


def max_pool(in_feats, rulebook_idx, out_valid):
    """(V_in, C) -> (V_out, C): the maximum over each output site's
    window. ``rulebook_idx`` (K, V_out) indexes the input, V_in where
    absent; a missing entry reads the lowest f32, a non-finite result
    becomes 0 and invalid output rows are 0. Output in the input dtype."""
    lowest = torch.finfo(torch.float32).min
    src = _with_pad_row(in_feats, lowest)
    idx = rulebook_idx.to(torch.int64)
    out = torch.full((idx.shape[1], in_feats.shape[-1]), lowest,
                     dtype=torch.float32, device=in_feats.device)
    for k in range(idx.shape[0]):
        out = torch.maximum(out, src[idx[k]])
    out = torch.where(torch.isfinite(out), out, 0.0)
    out = torch.where(out_valid[:, None], out, 0.0)
    return out.to(in_feats.dtype)


def _present_mean(feats, idx, out_valid):
    """The mean over each output row's present entries (index < V) of
    ``idx`` (K, V_out) into ``feats`` (V, C); 0 where none is present or
    the row is invalid."""
    v = feats.shape[0]
    src = _with_pad_row(feats, 0.0)
    idx = idx.to(torch.int64)
    acc = torch.zeros((idx.shape[1], feats.shape[-1]), dtype=torch.float32,
                      device=feats.device)
    cnt = torch.zeros((idx.shape[1],), dtype=torch.float32,
                      device=feats.device)
    for k in range(idx.shape[0]):
        acc = acc + src[idx[k]]
        cnt = cnt + (idx[k] < v).to(torch.float32)
    out = acc / torch.clamp(cnt, min=1.0)[:, None]
    out = torch.where(out_valid[:, None], out, 0.0)
    return out.to(feats.dtype)


def avg_pool(in_feats, rulebook_idx, out_valid):
    """Mean over the present (active) inputs of each kernel window."""
    return _present_mean(in_feats, rulebook_idx, out_valid)


def unpool(coarse_feats, deconv_rulebook_idx, fine_valid):
    """Each coarse feature broadcast to the fine sites it covers: the
    mean over the offsets that reach a fine site (SCN UnPooling for
    disjoint windows). ``deconv_rulebook_idx`` (K, V_fine) indexes the
    coarse table, V_coarse where absent."""
    return _present_mean(coarse_feats, deconv_rulebook_idx, fine_valid)
