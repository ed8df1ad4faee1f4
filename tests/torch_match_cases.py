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
