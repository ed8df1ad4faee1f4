"""The ``single`` window: an interactive user who uploads one scan and
waits. One building at a time, ``engine/trainer.pad_scene`` then the
raw-form predict of ``make_predict_fn`` and the detections on the host,
until the run's seconds are spent; ``latency_p95_s`` is the 95th
percentile of those times. The loop is closed. (windows/stream.py says
what a window file returns.)
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import numpy as np

from perfbench.trace import SubWindow


def _unpack(packed: np.ndarray) -> Dict[str, np.ndarray]:
    v = packed[:, 9] > 0.5
    return {"boxes": packed[v, :7], "scores": packed[v, 7],
            "labels": packed[v, 8].astype(np.int32)}


def window(run) -> Dict:
    """Serve one building at a time; see the module docstring."""
    from detection_3d_tpu_torch.engine.inference import make_predict_fn
    from detection_3d_tpu_torch.engine.trainer import pad_scene
    t = run.traffic
    predict = make_predict_fn(run.cfg, run.model, run.device)
    pool = run.pool

    def one(i):
        t0 = time.perf_counter()
        out, true_num = predict(pad_scene(run.cfg, pool[i % len(pool)]))
        packed = out.cpu().numpy()
        int(true_num)
        return time.perf_counter() - t0, _unpack(packed)

    for i in range(int(t["warm_buildings"])):
        one(i)
    first, count = int(t["profile_after"]), int(t["profile_buildings"])
    sub = SubWindow(run.device) if run.trace else None
    lat, answers, built = [], [], []
    run.window_starts()
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        if sub is not None and i == first:
            sub.start()
        dt, det = one(i)
        if sub is not None and i == first + count - 1:
            sub.stop(count)
        lat.append(dt)
        answers.append((i % len(pool), det))
        built.append(i % len(pool))
        i += 1
    wall = time.perf_counter() - t0
    if sub is not None and sub.seconds is None:
        sub = None      # the window ended before the sub-window did
    p95 = float(np.percentile(np.asarray(lat), 95))
    print(f"single window: {len(lat)} buildings in {wall:.4f} s, latency "
          f"median {float(np.median(lat)):.6f} s, p95 {p95:.6f} s over "
          f"{len(lat)} samples", file=sys.stderr)
    return {"e2e": {"latency_p95_s": p95}, "answers": answers,
            "window_s": wall, "buildings": built, "timings": {},
            "sub_buildings": built[first:first + count], "sub": sub}
