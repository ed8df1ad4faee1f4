"""Voxel tables for the submanifold-match tests, numpy only, so that the
CPU parity tests (tests/test_torch_subm_columns.py, with JAX) and the
card tests (tests/test_torch_kernels_cuda.py, without it) build the same
tables: random sites, sites packed on every face and corner, full z
columns on the grid's edges, two batches, and capacities off kernel B's
256-site block (csrc/subm_match.cu).
"""

import numpy as np

BLOCK = 256     # sites per block of csrc/subm_match.cu


def random_coords(n, spatial, seed, batch=1):
    rng = np.random.RandomState(seed)
    return np.stack([rng.randint(0, spatial[0], n),
                     rng.randint(0, spatial[1], n),
                     rng.randint(0, spatial[2], n),
                     rng.randint(0, batch, n)], -1).astype(np.int32)


def edge_coords(spatial, seed):
    """Sites packed against every face and corner of the grid, where a
    shifted key would alias a voxel of the next column."""
    rng = np.random.RandomState(seed)
    X, Y, Z = spatial
    pts = [[x, y, z, 0] for x in (0, X - 1) for y in (0, Y - 1)
           for z in (0, Z - 1)]
    for _ in range(400):
        face = rng.randint(3)
        c = [rng.randint(X), rng.randint(Y), rng.randint(Z), 0]
        c[face] = (0, spatial[face] - 1)[rng.randint(2)]
        pts.append(c)
        c2 = list(c)
        c2[2] = min(Z - 1, c2[2] + 1)
        pts.append(c2)
    return np.array(pts, np.int32)


def column_coords(spatial, seed):
    """Full z columns on the y = 0 / Y-1 and x = 0 / X-1 lines, beside
    partial columns one step in: keys +-1 there cross to the next column,
    and shifted keys to the next x plane."""
    rng = np.random.RandomState(seed)
    X, Y, Z = spatial
    pts = [[x, y, z, 0] for x in (0, 1, X - 2, X - 1)
           for y in (0, 1, Y - 2, Y - 1) for z in range(Z)
           if z % (2 + (x + y) % 3) or x in (0, X - 1)]
    pts += [[rng.randint(X), rng.randint(Y), rng.randint(Z), 0]
            for _ in range(300)]
    return np.array(pts, np.int32)


# name -> (coords, spatial, capacity, batch)
MATCH_CASES = {
    "partial": lambda: (random_coords(900, (64, 48, 32), 2), (64, 48, 32),
                        4096, 1),
    "dense": lambda: (random_coords(7000, (16, 24, 24), 5), (16, 24, 24),
                      8192, 1),
    "edges": lambda: (edge_coords((64, 48, 32), 3), (64, 48, 32), 2048, 1),
    "columns": lambda: (column_coords((12, 10, 16), 4), (12, 10, 16),
                        2048, 1),
    "batch2": lambda: (random_coords(3000, (64, 48, 32), 4, 2), (64, 48, 32),
                       4096, 2),
    "ragged": lambda: (random_coords(1500, (32, 32, 16), 6), (32, 32, 16),
                       5 * BLOCK + 37, 1),
    "tiny": lambda: (random_coords(120, (6, 5, 7), 7, 2), (6, 5, 7),
                     BLOCK - 56, 2),
}


def unique_coords(n, spatial, seed):
    """Exactly ``n`` distinct sites (fewer if the grid holds fewer)."""
    c = random_coords(2 * n, spatial, seed)
    c = c[np.sort(np.unique(c, axis=0, return_index=True)[1])]
    return c[:n]


# kernel D's tables (csrc/multi_match.cu), name -> (coords, spatial,
# capacity): 2^17 rows (the binary and compact forms' many levels; the
# 4-ary form's top of 2 keys at stride 4^8), 16384 rows (a full 4-ary top
# of 4 keys at stride 4^6) and 16385 (a top of 2 at stride 4^7, the
# second the last row), a capacity that is no multiple of 4 (24581) and
# real rows that end inside a 4-ary node (20006 of 32768 = 4 * 5001 + 2)
D_TABLES = {
    "large": lambda: (random_coords(100000, (128, 96, 64), 11),
                      (128, 96, 64), 1 << 17),
    "full_top": lambda: (random_coords(14000, (64, 48, 32), 12),
                         (64, 48, 32), 16384),
    "top_plus_one": lambda: (unique_coords(16385, (64, 48, 32), 13),
                             (64, 48, 32), 16385),
    "ragged_v": lambda: (random_coords(20000, (64, 48, 32), 14),
                         (64, 48, 32), 3 * 8192 + 5),
    "mid_node": lambda: (unique_coords(20006, (64, 48, 32), 15),
                         (64, 48, 32), 32768),
}

INVALID_KEY = ((2**31 - 1) << 32) | 5   # high half INVALID: an invalid query


def d_queries(keys, order, seed, n=None):
    """Composite int64 queries against a table's sorted int64 ``keys``:
    hits (real keys), misses (a real key - 1 or + 1), keys below the
    smallest and above the largest real key, and invalid ones (every
    17th), ``n`` of them (default 5003, no multiple of 4), in ``order``:
    "sorted", "deconv" (sorted by the high half only, as deconv queries
    are sorted in x only), "shuffled", or "all_invalid"."""
    rng = np.random.RandomState(seed)
    n = 5003 if n is None else n
    real = keys[(keys >> 32) != 2**31 - 1]
    q = real[rng.randint(0, real.size, n)] + rng.randint(-1, 2, n)
    q[1::23] = real[0] - 1 - rng.randint(0, 1000, q[1::23].size)
    q[2::23] = real[-1] + 1 + rng.randint(0, 1000, q[2::23].size)
    q[3::23] = real[0]
    q[4::23] = real[-1]
    q[::17] = INVALID_KEY
    if order == "all_invalid":
        q[:] = INVALID_KEY
    if order == "sorted":
        q = np.sort(q)
    elif order == "deconv":
        q = q[np.argsort(q >> 32, kind="stable")]
    return q.astype(np.int64)
