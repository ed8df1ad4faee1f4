"""Target assignment (matcher) and balanced sampling, masked/static-shape.

Counterpart of detection_3d_tpu/models/matcher.py (reference Matcher,
matcher.py:12-197, and BalancedPositiveNegativeSampler):

  * optional yaw gate: quality *= (|yaw_diff| < yaw_threshold) when the
    threshold is <= 1.58;
  * per-anchor argmax over gt; < low -> -1 (background), [low, high) ->
    -2 (ignore);
  * allow_low_quality: anchors tying a gt's best quality are rescued to
    their argmax, only for a gt whose best quality is > 0;
  * ignore-highest-nearby: negatives whose quality vs any gt exceeds
    max(best_for_gt - 0.05, 0.02) become ignores.

The sampler takes its uniform priorities as a tensor: the caller draws
them (from an explicit ``torch.Generator``, or hands in the JAX
package's ``jax.random.uniform`` draws in the parity tests).
"""

from __future__ import annotations

import torch

BELOW_LOW = -1
BETWEEN = -2
_NEG = -1e9


def match_boxes(quality, gt_valid, anchor_valid, high: float, low: float,
                allow_low_quality: bool, yaw_diff=None,
                yaw_threshold: float = 10.0,
                ignore_highest_nearby: bool = True):
    """quality (M, N) gt rows x anchor columns; gt_valid (M,),
    anchor_valid (N,). Returns (N,) int32 matches in [0, M) or
    BELOW_LOW / BETWEEN; padded anchors get BELOW_LOW."""
    pair_ok = gt_valid[:, None] & anchor_valid[None, :]
    q = torch.where(pair_ok, quality, _NEG)
    if yaw_diff is not None and yaw_threshold <= 1.58:
        q = q * (torch.abs(yaw_diff) < yaw_threshold).to(q.dtype)
        q = torch.where(pair_ok, q, _NEG)

    matched_vals, all_matches = torch.max(q, dim=0)
    all_matches = all_matches.to(torch.int32)
    matches = torch.where(matched_vals < low, BELOW_LOW, all_matches)
    matches = torch.where((matched_vals >= low) & (matched_vals < high),
                          BETWEEN, matches)

    if allow_low_quality:
        highest_per_gt = torch.max(q, dim=1).values           # (M,)
        # a gt with zero overlap everywhere would tie with every
        # zero-quality anchor: require a strictly positive best quality
        tie = (q == highest_per_gt[:, None]) & \
            (highest_per_gt[:, None] > 0) & pair_ok
        matches = torch.where(tie.any(0), all_matches, matches)
        if ignore_highest_nearby:
            thr = torch.clamp(highest_per_gt - 0.05, min=0.02)
            near_any = ((q > thr[:, None]) & gt_valid[:, None]).any(0)
            matches = torch.where(near_any & (matches == BELOW_LOW),
                                  BETWEEN, matches)

    return torch.where(anchor_valid, matches, BELOW_LOW).to(torch.int32)


def _rank_among(mask, priority):
    """Rank (0-based) of each True element among the Trues, by priority
    descending, ties lowest index first (jnp.argsort descending, stable).
    False elements get rank N."""
    n = mask.shape[0]
    p = torch.where(mask, priority, _NEG)
    order = torch.sort(p, descending=True, stable=True).indices
    ranks = torch.empty((n,), dtype=torch.int64, device=mask.device)
    ranks[order] = torch.arange(n, device=mask.device)
    return torch.where(mask, ranks, n)


def balanced_sample(labels, priorities, batch_size: int,
                    positive_fraction: float):
    """labels (N,): ignore < 0, negative == 0, positive > 0; priorities
    (N,) uniform draws. Returns (pos_mask, neg_mask) with |pos| =
    min(#pos, batch * frac) and |neg| = min(#neg, batch - |pos|), the
    highest priorities of each kind."""
    is_pos = labels >= 1
    is_neg = labels == 0
    num_pos_cap = int(batch_size * positive_fraction)
    pos_mask = is_pos & (_rank_among(is_pos, priorities) < num_pos_cap)
    n_pos = pos_mask.sum()
    neg_mask = is_neg & (_rank_among(is_neg, priorities)
                         < (batch_size - n_pos))
    return pos_mask, neg_mask
