"""The pool of buildings a run serves or trains on, made from the run's
seed by the general generator (synthetic.py) with a traffic file's
``buildings`` parameters; numpy only, so that its worker processes
start without loading torch.

``buildings`` holds ``pool`` (the number of buildings) and the
generator's ``num_points``, ``rooms_xy`` and ``room``. A mix of sizes
adds ``sizes``, a list of {"count": k, and any of those keys}: k
buildings take the entry's values over the others, the counts sum to
``pool``, and the seed orders the buildings, so that every seed serves
the same set of sizes."""

from __future__ import annotations

import multiprocessing
import os
from typing import Dict, List

import numpy as np

from perfbench.traffic.synthetic import synthetic_multiroom

# synthetic_multiroom seeds room r of a building with seed * 1000 + r,
# and numpy's RandomState takes seeds below 2^32
_BUILDING_SEEDS = 1 << 22


def building_seeds(seed: int, n: int) -> List[int]:
    """``n`` distinct building seeds drawn from the run's seed (any
    non-negative integer)."""
    rng = np.random.default_rng(seed)
    return [int(s) for s in rng.choice(_BUILDING_SEEDS, n, replace=False)]


def building_params(seed: int, params: Dict) -> List[Dict]:
    """The generator's parameters of each building of the pool, in the
    pool's order (the module docstring says how ``sizes`` mixes them)."""
    base = {k: params[k] for k in ("num_points", "rooms_xy", "room")
            if k in params}
    n = int(params["pool"])
    if "sizes" not in params:
        return [base] * n
    out = [dict(base, **{k: v for k, v in size.items() if k != "count"})
           for size in params["sizes"] for _ in range(int(size["count"]))]
    if len(out) != n:
        raise ValueError(f"the sizes' counts sum to {len(out)}, not the "
                         f"pool's {n}")
    order = np.random.default_rng([seed, 1]).permutation(n)
    return [out[i] for i in order]


def one_building(args):
    """The building of ``(seed, params, classes)``."""
    seed, params, classes = args
    return synthetic_multiroom(
        seed=seed, num_points=int(params["num_points"]),
        rooms_xy=tuple(params["rooms_xy"]), room=float(params["room"]),
        classes=tuple(classes))


class PendingPool:
    """The run's ``params["pool"]`` buildings, in a fixed order from the
    seed, generated by ``workers`` spawned processes (0: one a core, at
    most one a building; 1: in this process) from the moment it is made
    until :meth:`get` collects them and ends the workers."""

    def __init__(self, seed: int, params: Dict, classes, workers: int = 0):
        jobs = [(s, p, tuple(classes)) for s, p in zip(
            building_seeds(seed, int(params["pool"])),
            building_params(seed, params))]
        workers = workers or min(len(jobs), os.cpu_count() or 1)
        self._pool = self._result = None
        if workers <= 1:
            self._result = [one_building(j) for j in jobs]
        else:
            self._pool = multiprocessing.get_context("spawn").Pool(workers)
            self._async = self._pool.map_async(one_building, jobs,
                                               chunksize=1)

    def get(self) -> List:
        if self._pool is not None:
            try:
                self._result = self._async.get()
            finally:
                self._pool.close()
                self._pool.join()
                self._pool = None
        return self._result


def make_pool(seed: int, params: Dict, classes, workers: int = 0) -> List:
    """The pool's buildings (:class:`PendingPool`), waited for."""
    return PendingPool(seed, params, classes, workers).get()
