"""Kernel B's module (ops/sparse.py, models/backbone.build_pyramid): the
port's input layer, plain submanifold match, downsample and BEV books
against the JAX package, bit exact (integers must come out identical).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.models.backbone import build_pyramid as j_pyramid
from detection_3d_tpu.ops import sparse as jsparse
from detection_3d_tpu.ops.pallas.match_kernel import (
    neighbor_match_3x3x3 as j_match_interpret,
)
from detection_3d_tpu_torch.models.backbone import (
    bev_with_rulebook, build_pyramid,
)
from detection_3d_tpu_torch.ops import sparse as tsparse
from test_torch_common import (  # noqa: F401
    assert_tables_equal, cfg_pair, random_coords, scene_tables,
    table_pair,
)

OFFS3 = tsparse.submanifold_offsets((3, 3, 3))


def _edge_coords(spatial, seed):
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


@pytest.mark.parametrize("case", ["partial", "dense", "edges", "batch2"])
def test_subm_match_bit_exact(case):
    spatial = (16, 24, 24) if case == "dense" else (64, 48, 32)
    if case == "partial":      # table under half full: pad rows -> V
        coords, cap, batch = random_coords(900, spatial, 2), 4096, 1
    elif case == "dense":
        coords, cap, batch = random_coords(7000, spatial, 5), 8192, 1
    elif case == "edges":
        coords, cap, batch = _edge_coords(spatial, 3), 2048, 1
    else:
        coords, cap, batch = random_coords(3000, spatial, 4, 2), 4096, 2
    feats = np.zeros((coords.shape[0], 1), np.float32)
    jt, tt = table_pair(coords, feats, spatial, cap, batch=batch)
    assert_tables_equal(jt, tt)
    want = np.asarray(jsparse.neighbor_indices(jt, OFFS3))
    got = tsparse.neighbor_match_3x3x3(tt).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if batch == 1:
        np.testing.assert_array_equal(
            got, np.asarray(j_match_interpret(jt, interpret=True)))


def test_lex_sort_and_key_search_match_jax():
    """The int64 composite key sorts like the (hi, lo) pair (INVALID
    last) and one searchsorted finds what lex_searchsorted finds."""
    from detection_3d_tpu.ops import coords as jcoords
    from detection_3d_tpu_torch.ops import coords as tcoords
    spatial = (64, 48, 32)
    coords = random_coords(600, spatial, 8, batch=2)
    coords[::11, 1] = -3                                # out of the grid
    valid = np.random.RandomState(8).rand(600) > 0.2
    jhi, jlo = jcoords.pack_key(jnp.asarray(coords), spatial,
                                jnp.asarray(valid))
    thi, tlo = tcoords.pack_key(torch.from_numpy(coords), spatial,
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    rows = np.arange(600, dtype=np.int32)
    jsorted = jcoords.lex_sort(jhi, jlo, jnp.asarray(rows))
    tsorted = tcoords.lex_sort(thi, tlo, torch.from_numpy(rows))
    for a, b in zip(jsorted, tsorted):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    q = np.concatenate([coords[:200], random_coords(200, spatial, 9, 2)])
    qhi, qlo = jcoords.pack_key(jnp.asarray(q), spatial)
    jidx, jfound = jcoords.lex_searchsorted(jsorted[0], jsorted[1], qhi, qlo)
    keys = tcoords.composite_key(tsorted[0], tsorted[1])
    tidx, tfound = tcoords.key_search(keys, *tcoords.pack_key(
        torch.from_numpy(q), spatial))
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    assert tfound.any()
    found = tfound.numpy()
    np.testing.assert_array_equal(tidx.numpy()[found],
                                  np.asarray(jidx)[found])


def test_input_layer_overflow_and_row_map():
    """More voxels than capacity: the every-k-th subsampling, true_num
    and the row map match bit for bit; duplicates average their feats."""
    spatial = (32, 32, 16)
    rng = np.random.RandomState(7)
    coords = random_coords(3000, spatial, 7)
    coords = np.concatenate([coords, coords[:500]])     # duplicates
    feats = rng.randn(coords.shape[0], 3).astype(np.float32)
    valid = rng.rand(coords.shape[0]) > 0.1
    coords[::97, 0] = -1                                # out of the grid
    for cap in (4096, 1000):
        jt, jmap = jsparse.build_sparse_tensor(
            jnp.asarray(coords), jnp.asarray(feats), jnp.asarray(valid),
            spatial, 1, cap, return_row_map=True)
        tt, tmap = tsparse.build_sparse_tensor(
            torch.from_numpy(coords), torch.from_numpy(feats),
            torch.from_numpy(valid), spatial, 1, cap, return_row_map=True)
        assert_tables_equal(jt, tt)
        np.testing.assert_array_equal(tmap.numpy(), np.asarray(jmap))
    assert int(tt.true_num) > cap                       # overflow case ran


def test_downsample_and_bev_books_bit_exact():
    spatial = (64, 48, 32)
    jt, tt = table_pair(random_coords(2500, spatial, 9),
                        np.zeros((2500, 1), np.float32), spatial, 4096)
    jo, jc, jd = jsparse.downsample_with_rulebooks(jt, (2, 2, 2), (2, 2, 2),
                                                   2048)
    to, tc, td = tsparse.downsample_with_rulebooks(tt, (2, 2, 2), (2, 2, 2),
                                                   2048)
    assert_tables_equal(jo, to)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    from detection_3d_tpu.models.backbone import bev_with_rulebook as j_bev
    jb, jrb = j_bev(jt, jt.capacity)
    tb, trb = bev_with_rulebook(tt, tt.capacity)
    assert_tables_equal(jb, tb)
    np.testing.assert_array_equal(trb.numpy(), np.asarray(jrb))


def test_build_pyramid_bit_exact():
    jcfg, tcfg = cfg_pair()
    jt, tt = scene_tables(jcfg, tcfg)
    jp = j_pyramid(jt, jcfg)
    tp = build_pyramid(tt, tcfg)
    assert len(jp["tables"]) == len(tp["tables"]) == 5
    for a, b in zip(jp["tables"], tp["tables"]):
        np.testing.assert_array_equal(b.coords.numpy(), np.asarray(a.coords))
        assert int(a.num) == int(b.num)
    for key in ("subm_idx", "down_rb", "up_rb"):
        assert len(jp[key]) == len(tp[key])
        for a, b in zip(jp[key], tp[key]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert set(jp["bev"]) == set(tp["bev"])
    for slot, (jb, jrb) in jp["bev"].items():
        tb, trb = tp["bev"][slot]
        np.testing.assert_array_equal(tb.coords.numpy(), np.asarray(jb.coords))
        np.testing.assert_array_equal(trb.numpy(), np.asarray(jrb))
