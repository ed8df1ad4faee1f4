"""The ``train`` window: training the model one building a step, as the
source's ``IMS_PER_BATCH: 1`` does: ``engine/trainer.pad_scene`` then
``Trainer.step``, the samplers' uniform draws made from the seed on the
card and handed in. Set-up builds one ``Trainer`` and its state on the
benchmark's weights and drives it through the first ``checked_steps``
steps, on distinct buildings, through the same call as the window; the
window goes on with that same state, over the pool in a fresh order each
pass, until the run's seconds are spent. ``s_per_step`` is the window's
wall time over its steps. (windows/stream.py says what a window file
returns; perfbench/train.py holds the check.)
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.trace import SubWindow
from perfbench.train import draws


def _out_dir() -> str:
    """Where the trainer may put files (it writes none here): the run's
    TMPDIR, else a directory in the checkout."""
    base = os.environ.get("TMPDIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".out")
    return os.path.join(base, "perfbench_train")


def window(run) -> Dict:
    """Train on the pool; see the module docstring."""
    from detection_3d_tpu_torch.engine.trainer import Trainer, pad_scene
    t = run.traffic
    dev, cfg, pool = run.device, run.cfg, run.pool
    trainer = Trainer(cfg, output_dir=_out_dir(), device=dev)
    state = trainer.init_state(model=run.model)
    shapes = state.model.priority_shapes()
    gen = torch.Generator(device=dev).manual_seed(run.seed % (1 << 63))

    def one(b, pri):
        return trainer.step(state, pad_scene(cfg, pool[b]), priorities=pri)

    checked = int(t["checked_steps"])
    record = {"totals": [], "draws": []}
    names = [n for n, _ in state.model.named_parameters()]
    for s in range(checked):
        pri = draws(shapes, gen, dev)
        record["draws"].append({k: v.cpu() for k, v in pri.items()})
        record["totals"].append(one(s, pri)[0])
        if s == 0:
            bufs = state.solver.optimizer.state
            record["first"] = {n: bufs[p]["momentum_buffer"].cpu().clone()
                               for n, p in state.model.named_parameters()}
    record["after"] = {n: p.detach().cpu().clone()
                       for n, p in zip(names, state.model.parameters())}

    rng = np.random.default_rng(run.seed)
    order: List[int] = []
    first, count = int(t["profile_after"]), int(t["profile_steps"])
    sub = SubWindow(dev) if run.trace else None
    steps, built = 0, []
    run.window_starts()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        if not order:
            order = [int(i) for i in rng.permutation(len(pool))]
        b = order.pop()
        if sub is not None and steps == first:
            sub.start()
        one(b, draws(shapes, gen, dev))
        if sub is not None and steps == first + count - 1:
            sub.stop(count)
        built.append(b)
        steps += 1
    wall = time.perf_counter() - t0
    if sub is not None and sub.seconds is None:
        sub = None      # the window ended before the sub-window did
    print(f"train window: {steps} steps in {wall:.4f} s", file=sys.stderr)
    return {"e2e": {"s_per_step": wall / steps}, "answers": record,
            "window_s": wall, "buildings": built,
            "sub_buildings": built[first:first + count], "timings": {},
            "sub": sub}
