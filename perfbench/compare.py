"""How a served building's detections are held against the reference's
(the detector family's ``serving_numbers``, families/sparse_rcnn.py),
and how a cell's numbers are judged by its limits (:func:`judge`).

Each detection of the program (box, score, label) is looked for among
the reference's detections of the same label whose 7 box numbers all
lie within BOX_TOL of its own, and each of the reference's among the
program's. At random weights one-ulp differences reorder the RPN's
top-n cut and near-equal scores, so some detections of a sound run have
no such partner:

  unmatched  the largest share, over the compared buildings and the two
             sides, of a side's detections with no partner on the other
             (a building with no detections on one side reads 1);

and, read over the detections that have one, by no limit (the fp8
control reads them under 3x the program's largest reading, PERF.md):

  score_gap_median  the median score difference of a detection and
                    its partner;
  score_gap         the largest one.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BOX_TOL = 0.01      # metres (radians for the yaw)


def building_numbers(got: Dict[str, np.ndarray],
                     want: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The numbers of one building: ``got`` the program's detections,
    ``want`` the reference's, each {boxes (K, 7), scores (K,), labels
    (K,)} of the valid rows."""
    n_got, n_want = len(got["scores"]), len(want["scores"])
    out = {"unmatched": 0.0 if n_got == n_want == 0 else 1.0,
           "score_gap": 0.0, "score_gap_median": 0.0}
    if n_got == 0 or n_want == 0:
        return out
    d = np.abs(got["boxes"][:, None, :].astype(np.float64)
               - want["boxes"][None, :, :]).max(-1)
    d = np.where(got["labels"][:, None] == want["labels"][None, :], d,
                 np.inf)
    best = d.argmin(1)
    hit = d[np.arange(n_got), best] <= BOX_TOL
    hit_want = d.min(0) <= BOX_TOL
    out["unmatched"] = float(max(1.0 - hit.mean(), 1.0 - hit_want.mean()))
    if hit.any():
        gap = np.abs(got["scores"][hit].astype(np.float64)
                     - want["scores"][best[hit]])
        out["score_gap"] = float(gap.max())
        out["score_gap_median"] = float(np.median(gap))
    return out


def worst(per_building: List[Dict[str, float]]) -> Dict[str, float]:
    """The largest of each number over the compared buildings."""
    keys = per_building[0].keys()
    return {k: max(b[k] for b in per_building) for k in keys}


def judge(numbers: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, List[Tuple]]:
    """(correct, [(name, number, limit)]) of the numbers that have a
    limit: correct when each is at or under it."""
    rows = [(k, numbers[k], limits[k]) for k in sorted(limits)]
    return all(v <= lim for _, v, lim in rows), rows
