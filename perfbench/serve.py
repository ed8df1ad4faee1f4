"""The check of the serving windows (windows/stream.py, windows/single.py):
once the window has closed, a sample of its answers, drawn from the
seed, is held against the reference's answers to the same buildings
(harness.check, the family's ``serving_numbers``).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def sample_answers(answers: List, n: int, seed: int) -> List:
    """``n`` answers of the window drawn from the seed, at most one of
    each building of the pool (a building's answers are all alike)."""
    rng = np.random.default_rng(seed)
    by_building: Dict[int, List[int]] = {}
    for j, (b, _) in enumerate(answers):
        by_building.setdefault(b, []).append(j)
    keys = sorted(by_building)
    picked = rng.choice(len(keys), min(n, len(keys)), replace=False)
    return [answers[int(rng.choice(by_building[keys[int(k)]]))]
            for k in sorted(picked)]
