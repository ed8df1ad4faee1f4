"""Kernel D's entry points against the JAX package, on the CPU (the
kernel's forms in torch), bit exact:
``conv_rulebook_match`` and ``deconv_rulebook_match`` against the JAX
kernel in interpret mode and against JAX's ``conv_rulebook`` /
``deconv_rulebook`` (as tests/test_pallas_match.py holds the JAX
kernel), and against the scatter-derived books of the port's
``downsample_with_rulebooks``. ``multi_match_quad`` (the 4-ary form of
kernel D) against ``multi_match_plain`` on kernel D's edge tables
(tests/torch_match_cases.D_TABLES) and on tables of every size around
powers of 4, and against the JAX kernel in interpret mode.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.ops import sparse as jsparse
from detection_3d_tpu.ops.pallas import match_kernel as jmatch
from detection_3d_tpu.ops.sparse_conv import deconv_rulebook as j_deconv_rb
from detection_3d_tpu_torch.ops.coords import INVALID, composite_key
from detection_3d_tpu_torch.ops.multi_match import (
    QUAD_MAX_N, conv_rulebook_match, deconv_rulebook_match, multi_match,
    multi_match_form, multi_match_plain, multi_match_quad,
    sorted_multi_match)
from detection_3d_tpu_torch.ops.sparse import (
    build_sparse_tensor, downsample_with_rulebooks)
from test_torch_common import random_coords, table_pair
from torch_match_cases import D_TABLES, d_queries

SPATIAL = (64, 48, 32)
K2 = (2, 2, 2)


def _pair(n, cap, seed, spatial=SPATIAL):
    coords = random_coords(n, spatial, seed)
    feats = np.random.RandomState(seed).randn(n, 4).astype(np.float32)
    return table_pair(coords, feats, spatial, cap)


@pytest.fixture(scope="module", params=[(2500, 4096, 7), (900, 4096, 2),
                                        (3000, 4096, 9)])
def pyramid_pair(request):
    """Fine tables of both packages, the port's coarse table with its
    scatter books, and the JAX coarse table."""
    n, cap, seed = request.param
    jt, tt = _pair(n, cap, seed)
    coarse, crb, drb = downsample_with_rulebooks(tt, K2, K2, 2048)
    jcoarse = jsparse.downsample_table(jt, K2, K2, 2048)
    np.testing.assert_array_equal(coarse.coords.numpy(),
                                  np.asarray(jcoarse.coords))
    return jt, tt, jcoarse, coarse, crb, drb


def test_conv_rulebook_match_bit_exact(pyramid_pair):
    jt, tt, jcoarse, coarse, crb, _ = pyramid_pair
    got = conv_rulebook_match(coarse, tt, K2, K2)
    assert got.dtype == torch.int32 and got.shape == (8, coarse.capacity)
    want = np.asarray(jsparse.conv_rulebook(jcoarse, jt, K2, K2))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), crb.numpy())


def test_deconv_rulebook_match_bit_exact(pyramid_pair):
    jt, tt, jcoarse, coarse, _, drb = pyramid_pair
    got = deconv_rulebook_match(tt, coarse, K2, K2)
    assert got.shape == (8, tt.capacity)
    want = np.asarray(j_deconv_rb(jt, jcoarse, K2, K2))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), drb.numpy())


@pytest.mark.parametrize("which", ["conv", "deconv"])
def test_matches_jax_kernel_in_interpret_mode(which):
    jt, tt = _pair(2500, 4096, 8)
    coarse, _, _ = downsample_with_rulebooks(tt, K2, K2, 2048)
    jcoarse = jsparse.downsample_table(jt, K2, K2, 2048)
    if which == "conv":
        want = jmatch.conv_rulebook_match(jcoarse, jt, K2, K2,
                                          interpret=True)
        got = conv_rulebook_match(coarse, tt, K2, K2)
    else:
        want = jmatch.deconv_rulebook_match(jt, jcoarse, K2, K2,
                                            interpret=True)
        got = deconv_rulebook_match(tt, coarse, K2, K2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sorted_multi_match_contract():
    """Found keys give their row, absent or invalid ones V; the queries
    need not be sorted."""
    _, tt = _pair(500, 1024, 3)
    v, num = tt.capacity, int(tt.num)
    rng = np.random.RandomState(0)
    rows = torch.from_numpy(rng.permutation(num)[:200])
    qhi, qlo = tt.hi[rows].clone(), tt.lo[rows].clone()
    qhi[::5] += 100000                      # keys no table row holds
    qvalid = torch.ones(200, dtype=torch.bool)
    qvalid[1::7] = False
    got = sorted_multi_match(qhi[None], qlo[None], qvalid[None], tt)[0]
    want = torch.where(qvalid, rows.to(torch.int32), v)
    want[::5] = v
    assert torch.equal(got, want)


def test_multi_match_plain_edges():
    keys = composite_key(torch.tensor([0, 0, 3, INVALID], dtype=torch.int32),
                         torch.tensor([1, 5, 2, INVALID], dtype=torch.int32))
    q = composite_key(torch.tensor([0, 3, 0, INVALID, 9], dtype=torch.int32),
                      torch.tensor([5, 2, 2, INVALID, 0], dtype=torch.int32))
    want = torch.tensor([1, 2, 4, 4, 4], dtype=torch.int32)
    assert torch.equal(multi_match_plain(keys, q), want)
    assert torch.equal(multi_match(keys, q), want)


@pytest.mark.parametrize("table", sorted(D_TABLES))
def test_quad_matches_plain_on_edge_tables(table):
    """Kernel D's 4-ary form in torch against the plain lower bound, bit
    exact, on every order of queries (hits, misses, keys below and above
    the real ones, invalid ones); ``multi_match`` takes it on the CPU."""
    coords, spatial, cap = D_TABLES[table]()
    keys = build_sparse_tensor(torch.from_numpy(coords),
                               torch.zeros((coords.shape[0], 0)), None,
                               spatial, 1, cap).keys
    for order in ("sorted", "deconv", "shuffled", "all_invalid"):
        q = torch.from_numpy(d_queries(keys.numpy(), order, 7))
        want = multi_match_plain(keys, q)
        assert torch.equal(multi_match_quad(keys, q), want), order
        assert torch.equal(multi_match(keys, q), want), order
    assert multi_match_form(cap, q.numel()) == "quad"


@pytest.mark.parametrize("v", [1, 2, 3, 4, 5, 15, 16, 17, 63, 64, 65, 255,
                               256, 257, 1023, 1024, 1025])
def test_quad_matches_plain_around_powers_of_four(v):
    """Tables of 1 to 1025 rows (a top of 1 to 4 keys, a level's last node
    cut short), real rows in every count up to the capacity."""
    rng = np.random.RandomState(v)
    for real in sorted({0, 1, v // 2, max(v - 1, 0), v}):
        ks = np.sort(rng.choice(10 ** 6, real, replace=False)).astype(
            np.int64)
        keys = np.concatenate([ks, np.full(v - real, (INVALID << 32)
                                           | INVALID, np.int64)])
        q = np.concatenate([ks, ks + 1, ks - 1, [-1, 0, 10 ** 6 + 7,
                                                 (INVALID << 32) | 5]])
        keys_t, q_t = torch.from_numpy(keys), torch.from_numpy(q)
        assert torch.equal(multi_match_quad(keys_t, q_t),
                           multi_match_plain(keys_t, q_t)), real


def test_forms_by_size():
    """The 4-ary form up to QUAD_MAX_N queries, compaction for large sets
    of at least 8 queries a table row, the binary search otherwise."""
    assert multi_match_form(524288, QUAD_MAX_N) == "quad"
    assert multi_match_form(524288, 2 * 1048576) == "binary"
    assert multi_match_form(262144, 4 * 1048576) == "compact"
    assert multi_match_form(131072, 1048576) == "compact"
    assert multi_match_form(32768, 524288) == "binary"


@pytest.mark.parametrize("table", ["full_top", "mid_node"])
def test_quad_matches_jax_kernel_in_interpret_mode(table):
    """multi_match_quad against JAX's sorted_multi_match (the Pallas
    kernel in interpret mode) on the same table and sorted queries, with
    queries below and above the real keys; the capacities are multiples
    of the Pallas kernel's 128 lanes."""
    coords, spatial, cap = D_TABLES[table]()
    coords = coords[:min(coords.shape[0], 3000)]
    feats = np.zeros((coords.shape[0], 1), np.float32)
    jt, tt = table_pair(coords, feats, spatial, cap)
    q = d_queries(tt.keys.numpy(), "sorted", 9, n=3000)
    qhi, qlo = (q >> 32).astype(np.int32), (q & 0xFFFFFFFF).astype(np.int32)
    valid = qhi != INVALID
    want = jmatch.sorted_multi_match(jnp.asarray(qhi[None]),
                                     jnp.asarray(qlo[None]),
                                     jnp.asarray(valid[None]), jt,
                                     interpret=True)[0]
    got = multi_match_quad(tt.keys, torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int((got < cap).sum()) > 0
