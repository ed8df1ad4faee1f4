"""The port's host pyramid (data/pyramid_packing.py) against the JAX
package's pack_pyramid and against the port's own build_pyramid.

The port's numpy pack_pyramid must equal JAX's on every field both ship:
the pack_table fields, each scale's table and count, and every book's
``_idx`` against JAX's ``_idx`` or ``_idx_raw`` (the port ships no
windowed relayout). unpack_pyramid must equal build_pyramid on
unpack_table's table of the same pack: tables, books, BEV tables and
every RowOrder's perm and masks, all bit exact, with and without the
capacity-overflow keep at scale 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from detection_3d_tpu.data import pyramid_packing as jpyr
from detection_3d_tpu_torch.data import pyramid_packing as tpyr
from detection_3d_tpu_torch.data.packing import (
    pack_table, to_device, unpack_table,
)
from detection_3d_tpu_torch.models.backbone import build_pyramid
from detection_3d_tpu_torch.ops.sparse_conv import rulebook_row_order
from test_torch_common import cfg_pair, tiny_scene

CAPS0 = {"fits": 8192, "overflow": 4096, "overflow6": 1024}


def _cfgs(case):
    jc, tc = cfg_pair()
    return tuple(dataclasses.replace(
        c, caps=dataclasses.replace(
            c.caps, voxel_caps=(CAPS0[case],) + c.caps.voxel_caps[1:]))
        for c in (jc, tc))


@pytest.mark.parametrize("case", sorted(CAPS0))
def test_pack_pyramid_matches_jax(case):
    jc, tc = _cfgs(case)
    scene = tiny_scene(7)
    got = tpyr.pack_pyramid(tc, scene)
    want = jpyr.pack_pyramid(jc, scene)
    shared = 0
    for k, v in got.items():
        if k.endswith(("_perm", "_masks")):
            continue
        wk = k if k in want else k + "_raw"
        w = np.asarray(want[wk])
        assert v.dtype == w.dtype and v.shape == w.shape, k
        np.testing.assert_array_equal(v, w, err_msg=k)
        shared += 1
    # every book of JAX's pack is one of the port's
    books = {k.removesuffix("_raw").removesuffix("_idx") for k in want
             if k.endswith(("_idx", "_idx_raw"))}
    assert books == {k[:-len("_idx")] for k in got if k.endswith("_idx")}
    assert shared == len(got) - 2 * len(books)


def test_pack_spec_matches_pack():
    _, tc = cfg_pair()
    got = tpyr.pack_pyramid(tc, tiny_scene(8))
    spec = tpyr.pyramid_pack_spec(tc)
    assert set(got) == set(spec) | set(pack_table(tc, tiny_scene(8)))
    for k, (shape, dt) in spec.items():
        assert np.asarray(got[k]).shape == shape, k
        assert np.asarray(got[k]).dtype == dt, k
    # the narrowest unsigned mask type: subm 27 bits, down/up 8, BEV Z
    assert spec["subm0_masks"][1] == np.uint32
    assert spec["down0_masks"][1] == np.uint8
    assert spec["bev0_masks"][1] == np.uint16    # Z = 16 at that scale
    assert spec["bev1_masks"][1] == np.uint8     # Z = 8


def _eq(a, b, name):
    assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype)
    assert torch.equal(a, b), name


def _assert_tables_equal(a, b, name):
    for f in ("coords", "hi", "lo", "keys"):
        _eq(getattr(a, f), getattr(b, f), f"{name}.{f}")
    _eq(a.num, b.num, f"{name}.num")
    assert a.spatial_size == b.spatial_size, name
    assert a.feats.shape == b.feats.shape, name


def _assert_orders_equal(a, b, name):
    _eq(a.perm, b.perm, f"{name}.perm")
    _eq(a.masks, b.masks, f"{name}.masks")


@pytest.mark.parametrize("case", sorted(CAPS0))
def test_unpack_pyramid_matches_build_pyramid(case):
    _, tc = _cfgs(case)
    packed = to_device(tpyr.pack_pyramid(tc, tiny_scene(9)), "cpu")
    got = tpyr.unpack_pyramid(tc, packed)
    want = build_pyramid(unpack_table(tc, packed), tc)
    assert set(got) == set(want)
    _eq(got["tables"][0].true_num, want["tables"][0].true_num, "true_num")
    for k, (a, b) in enumerate(zip(got["tables"], want["tables"],
                                   strict=True)):
        _assert_tables_equal(a, b, f"table{k}")
    for key in ("subm", "down", "up"):
        for i, (a, b) in enumerate(zip(got[key], want[key], strict=True)):
            _eq(a.idx, b.idx, f"{key}[{i}].idx")
            _assert_orders_equal(a.order, b.order, f"{key}[{i}].order")
            assert a.bwd is b.bwd is None
    assert set(got["bev"]) == set(want["bev"])
    for slot in want["bev"]:
        (ta, ra), (tb, rb) = got["bev"][slot], want["bev"][slot]
        _assert_tables_equal(ta, tb, f"bev{slot}")
        _eq(ra.idx, rb.idx, f"bev{slot}.rb")
        _assert_orders_equal(ra.order, rb.order, f"bev{slot}.order")


@pytest.mark.parametrize("k", [1, 8, 9, 27, 33, 64])
def test_np_row_order_matches_rulebook_row_order(k):
    """The host's masks and stable order equal ops/sparse_conv's on a
    random book, for every mask width (64 offsets: the sign bit)."""
    rng = np.random.RandomState(k)
    v_in, v_out, num_out = 50, 300, 260
    idx = rng.randint(0, v_in + 1, (k, v_out)).astype(np.int32)
    idx[rng.rand(k, v_out) < 0.6] = v_in
    perm, masks = tpyr.np_row_order(idx, num_out, v_in)
    assert masks.dtype == tpyr.mask_dtype(k)
    want = rulebook_row_order(torch.from_numpy(idx), v_in,
                              torch.arange(v_out) < num_out)
    _eq(torch.from_numpy(perm), want.perm, "perm")
    _eq(torch.from_numpy(masks).to(torch.int64), want.masks, "masks")
