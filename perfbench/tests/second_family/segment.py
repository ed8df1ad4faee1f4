"""The ``segment`` window of the tests' second family (tiny_unet.py):
one building at a time, the program's ``segment`` from the raw building
to per-voxel logits on the host, until the run's seconds are spent;
``latency_p95_s`` is the 95th percentile of those times. The tests copy
this file into a checkout root as ``perfbench/windows/segment.py``
(windows/stream.py says what a window file returns)."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from perfbench.trace import SubWindow


def window(run) -> Dict:
    t, pool = run.traffic, run.pool

    def one(i):
        t0 = time.perf_counter()
        out = run.model.segment(pool[i % len(pool)], run.device)
        return time.perf_counter() - t0, out

    for i in range(int(t["warm_buildings"])):
        one(i)
    first, count = int(t["profile_after"]), int(t["profile_buildings"])
    sub = SubWindow(run.device) if run.trace else None
    lat, answers = [], []
    run.window_starts()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        i = len(lat)
        if sub is not None and i == first:
            sub.start()
        dt, out = one(i)
        if sub is not None and i == first + count - 1:
            sub.stop(count)
        lat.append(dt)
        answers.append((i % len(pool), out))
    wall = time.perf_counter() - t0
    if sub is not None and sub.seconds is None:
        sub = None      # the window ended before the sub-window did
    built = [b for b, _ in answers]
    return {"e2e": {"latency_p95_s": float(np.percentile(lat, 95))},
            "answers": answers, "window_s": wall, "buildings": built,
            "sub_buildings": built[first:first + count], "timings": {},
            "sub": sub}
