"""Box sets for the rotated-IoU tests (kernel C's cull and hull): numpy
only, so the card-only tests can use them without JAX."""

import numpy as np


def adversarial_bev(seed=0):
    """(N, 5) BEV boxes that stress kernel C's cull and hull: random
    boxes, identical, touching (edge, corner), nested, thin, 45-degree,
    turned copies, zero-size and zero-edge boxes, pad_scene's 0.1-size
    padding boxes, collinear walls with gaps around the 1e-3 cull margin
    at several angles, near-duplicates around the same-box margin, boxes
    at 80 m, boxes near the coordinates of the maps' pad rows (4.3e7 and
    1.4e9 m, where a float32 step is 4 and 128 m) with edges that do not
    collapse, touching or one step apart, and non-finite and negative
    sizes."""
    rng = np.random.RandomState(seed)
    rand = np.c_[rng.uniform(-4, 4, (160, 2)), rng.uniform(0.05, 3, (160, 2)),
                 rng.uniform(-3.2, 3.2, (160, 1))]
    base = [0.0, 0.0, 2.0, 1.0, 0.0]
    q4 = np.pi / 4
    special = [
        base, base, [2, 0, 2, 1, 0], [2, 1, 2, 1, 0], [0, 0, 1, 0.5, 0],
        [0, 0, 4, 0.095, 0.3], [0, 0, 0.09, 3, 0], [0, 0, 2, 1, q4],
        [0.5, 0.5, 1, 1, q4], [0, 0, 2, 1, np.pi / 2], [0, 0, 1, 2, 0],
        [0, 0, 0, 0, 0], [1, 0, 0, 1, 0], [0, 1, 2, 0, 0.3],
        [0, 0, 0.1, 0.1, 0], [0, 0, 0.1, 0.1, 0], [0, 0, 0.1, 0.1, 0],
        [5e-7, 0, 2, 1, 0], [2e-6, 0, 2, 1, 0], [0, 0, 2, 1, 5e-7],
        [80, 80, 0.2, 3, 0], [80.1, 80, 0.2, 3, 0], [80, 83.0009, 0.2, 3, 0],
        [80, 80, 1e-5, 1e-5, 0.3], [80, 80.5, 1e-9, 2, 0],
        [np.nan, 0, 1, 1, 0], [np.inf, 0, 1, 1, 0], [0, 0, np.inf, 1, 0],
        [0, 0, -1, 1, 0], [0, 0, 1e4, 1e4, 0.1], [0, 0, 1, 1, np.nan]]
    for far, step in ((4.294967e7, 4.0), (1.374389e9, 128.0)):
        for size in (0.4, 64 * step, 1000 * step):
            for ang in (0.0, 0.3, np.pi / 4):
                special.append([far, far, size, 1.5 * size, ang])
                special.append([far + size, far, size, 1.5 * size, ang])
                special.append([far, far + 1.5 * size + step, size,
                                1.5 * size, ang])
    walls = []
    for ang in (0.0, np.pi / 2, np.pi, -np.pi / 2, 0.3, 1.2):
        c, s = np.cos(ang), np.sin(ang)
        for gap in (0.0, 5e-4, 9.99e-4, 1e-3, 1.0001e-3, 1.5e-3, 1e-2):
            cx, cy = rng.uniform(-10, 10, 2)
            walls.append([cx, cy, 4.0, 0.1, ang])
            d = 4.0 + gap
            walls.append([cx + d * c, cy - d * s, 4.0, 0.1, ang])
            # the same wall beside it (gap across its thin side)
            d = 0.1 + gap
            walls.append([cx + d * s, cy + d * c, 4.0, 0.1, ang])
    for gap in (5e-4, 1e-3, 1.5e-3):     # gaps along x and y to the base
        walls.append([2 + gap, 0, 2, 1, 0])
        walls.append([0, 1 + gap, 2, 1, 0])
    return np.r_[rand, np.array(special), np.array(walls)].astype(np.float32)
