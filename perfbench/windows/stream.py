"""The ``stream`` window: a batch job that reconstructs a dataset of
buildings. The window is one ``engine/inference.run_inference(
pipelined=True)`` call over the pool cycled to the run's seconds times
the mix's ``sized_rate`` buildings (a fixed amount of work, about the
run's seconds long at the rate the program reached when the mix was
made); the program's own pack workers pack and copy unit i+1 while the
card runs unit i. ``s_per_building`` is the call's wall time over its
buildings, the first unit included. The loop is closed.

A window file (``windows/<name>.py``, named by a traffic mix's
``window``) has one entry, ``window(run)``: it warms up the shapes it
will use, calls ``run.window_starts()``, drives the program, and returns
{e2e, answers, window_s, buildings, sub_buildings, timings, sub}
(harness.py reads them).
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict

from perfbench.trace import SubWindow


class _Profiled:
    """The program's predict with a traced sub-window around units
    [first, first + count) of the window, when ``sub`` is given."""

    def __init__(self, predict, sub, first: int, count: int, per_unit: int):
        self.predict, self.sub = predict, sub
        self.first, self.count, self.per_unit = first, count, per_unit
        self.calls = 0

    def __call__(self, batch, phases=None):
        if self.sub is not None:
            if self.calls == self.first:
                self.sub.start()
            elif self.calls == self.first + self.count:
                self.sub.stop(self.count * self.per_unit)
        self.calls += 1
        return self.predict(batch)


def window(run) -> Dict:
    """Serve the pool in pipelined units; see the module docstring."""
    from detection_3d_tpu_torch.engine.inference import (
        make_batch_predict_fn, make_predict_fn, run_inference)
    t = run.traffic
    b, workers, mode = (int(t["batch_size"]), int(t["pack_workers"]),
                        t["pack_mode"])
    make = make_batch_predict_fn if b > 1 else make_predict_fn
    predict = make(run.cfg, run.model, run.device, packed=mode)
    pool = run.pool
    # warm-up: every shape of the window (a unit's shapes are static)
    warm = [pool[i % len(pool)] for i in range(b * int(t["warm_units"]))]
    run_inference(run.cfg, run.model, warm, run.device, predict_fn=predict,
                  pipelined=True, pack_workers=workers, pack_mode=mode,
                  batch_size=b)
    # a fixed amount of work: the run's seconds at the mix's stated rate
    units = max(int(t["min_units"]),
                math.ceil(run.seconds * float(t["sized_rate"]) / b))
    n = units * b
    scenes = [pool[i % len(pool)] for i in range(n)]
    first = units // 4
    count = min(int(t["profile_units"]), units - first - 1)
    sub = SubWindow(run.device) if run.trace and count > 0 else None
    profiled = _Profiled(predict, sub, first, count, b)
    run.window_starts()
    timings: Dict[str, float] = {}
    t0 = time.perf_counter()
    preds, _, _ = run_inference(run.cfg, run.model, scenes, run.device,
                                predict_fn=profiled, pipelined=True,
                                pack_workers=workers, pack_mode=mode,
                                timings=timings, batch_size=b)
    wall = time.perf_counter() - t0
    print(f"stream window: {n} buildings in {units} units of {b}, "
          f"{wall:.4f} s", file=sys.stderr)
    return {"e2e": {"s_per_building": wall / n},
            "answers": [(i % len(pool), {k: p[k] for k in
                                         ("boxes", "scores", "labels")})
                        for i, p in enumerate(preds)],
            "window_s": wall, "buildings": [i % len(pool) for i in range(n)],
            "sub_buildings": [i % len(pool)
                              for i in range(first * b, (first + count) * b)],
            "timings": timings, "sub": sub}
