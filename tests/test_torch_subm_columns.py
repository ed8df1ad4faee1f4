"""Kernel B's column algorithm in plain PyTorch (ops/sparse.
neighbor_match_columns), on the CPU: its (27, V) book bit exact against
the JAX package's neighbor_indices and its Pallas match kernel in
interpret mode, its row masks against ops/sparse_conv.row_masks, and
build_pyramid's submanifold row orders taken from those masks. The
tables are tests/torch_match_cases.py's, which the card tests share.
"""

import numpy as np
import pytest
import torch

from detection_3d_tpu.ops import sparse as jsparse
from detection_3d_tpu.ops.pallas.match_kernel import (
    neighbor_match_3x3x3 as j_match_interpret,
)
from detection_3d_tpu_torch.models.backbone import build_pyramid
from detection_3d_tpu_torch.ops import sparse as tsparse
from detection_3d_tpu_torch.ops.sparse_conv import (
    row_masks, rulebook_row_order,
)
from test_torch_common import (  # noqa: F401
    assert_tables_equal, cfg_pair, scene_tables, table_pair,
)
from torch_match_cases import MATCH_CASES

OFFS3 = tsparse.submanifold_offsets((3, 3, 3))


def _tables(case):
    coords, spatial, cap, batch = MATCH_CASES[case]()
    feats = np.zeros((coords.shape[0], 1), np.float32)
    jt, tt = table_pair(coords, feats, spatial, cap, batch=batch)
    assert_tables_equal(jt, tt)
    return jt, tt


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_columns_bit_exact_against_jax(case):
    jt, tt = _tables(case)
    want = np.asarray(jsparse.neighbor_indices(jt, OFFS3))
    got, masks = tsparse.neighbor_match_columns(tt)
    assert got.dtype == torch.int32 and masks.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU route of neighbor_match_3x3x3 is this function
    idx, masks_routed = tsparse.neighbor_match_3x3x3(tt)
    assert torch.equal(idx, got) and torch.equal(masks_routed, masks)


@pytest.mark.parametrize("case", ["partial", "dense", "edges", "columns",
                                  "batch2"])
def test_columns_bit_exact_against_pallas_interpret(case):
    """The Pallas kernel takes capacities that are multiples of its
    1024-row alignment."""
    jt, tt = _tables(case)
    got, _ = tsparse.neighbor_match_columns(tt)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_match_interpret(jt, interpret=True)))


@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_column_masks_are_the_books_row_masks(case):
    _, tt = _tables(case)
    want = tsparse.neighbor_indices(tt, OFFS3)
    got, masks = tsparse.neighbor_match_columns(tt)
    assert torch.equal(got, want)
    assert torch.equal(masks, row_masks(want, tt.capacity, tt.row_valid))
    assert int(masks[int(tt.num):].abs().sum()) == 0
    # every active site is its own neighbour at the centre offset
    assert bool(((masks[:int(tt.num)] >> 13) & 1).all())


@pytest.mark.parametrize("backward", [False, True])
def test_pyramid_subm_order_from_masks(backward):
    """build_pyramid's submanifold row orders, now from the book's masks,
    equal rulebook_row_order of each book (the previous route)."""
    _, tcfg = cfg_pair()
    _, tt = scene_tables(*cfg_pair())
    pyr = build_pyramid(tt, tcfg, backward=backward)
    for k, (t, book) in enumerate(zip(pyr["tables"], pyr["subm"])):
        want = rulebook_row_order(book.idx, t.capacity, t.row_valid)
        assert torch.equal(book.order.perm, want.perm), k
        assert torch.equal(book.order.masks, want.masks), k
        if backward:
            assert book.bwd.t_order is book.order
