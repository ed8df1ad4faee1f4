"""The one structure every pyramid producer returns (CPU, tiny sizes).

``build_pyramid`` (serving and training), ``plan_levels``,
``MinkUNet34C.plan`` and ``unpack_pyramid`` (of a serving pack and of a
training pack) all give ``{"tables", "subm", "down", "up"}`` in level
order, plus ``bev`` (the detector's) or ``stem`` (MinkUNet34C's). Every
book is an ``ops/sparse_conv.Book``: ``down[k]`` maps level k to k + 1,
``up[k]`` level k + 1 back to k, and each carries its backward book
exactly when the producer was asked for backward books.
"""

import pytest
import torch

from detection_3d_tpu_torch.config import defaults as tdefaults
from detection_3d_tpu_torch.data.packing import (
    batch_to_device, pad_scene, to_device)
from detection_3d_tpu_torch.data.pyramid_packing import (
    pack_pyramid, unpack_pyramid)
from detection_3d_tpu_torch.models import minkunet
from detection_3d_tpu_torch.models.backbone import build_pyramid
from detection_3d_tpu_torch.models.detector import voxelize_points
from detection_3d_tpu_torch.models.factories import plan_levels
from detection_3d_tpu_torch.ops.sparse import build_sparse_tensor
from detection_3d_tpu_torch.ops.sparse_conv import Book
from test_torch_common import tiny_cfg, tiny_scene
from torch_match_cases import random_coords

LEVELS = {"tables", "subm", "down", "up"}


def _detector_table(cfg):
    (pts, fts, valid), _, _ = batch_to_device(pad_scene(cfg, tiny_scene(3)),
                                              "cpu")
    return voxelize_points(cfg, pts, fts, valid)


def _small_table(cap=1024):
    coords = torch.from_numpy(random_coords(700, (24, 24, 16), 5))
    return build_sparse_tensor(coords, torch.ones((coords.shape[0], 3)),
                               None, (24, 24, 16), 1, cap)


def _build(producer):
    """(pyramid, its extra keys, whether backward books were asked)."""
    cfg = tiny_cfg(tdefaults)
    if producer in ("build_pyramid_serve", "build_pyramid_train"):
        backward = producer.endswith("train")
        return (build_pyramid(_detector_table(cfg), cfg, backward=backward),
                {"bev"}, backward)
    if producer == "plan_levels":
        return plan_levels(_small_table(), (1024, 512, 256)), set(), False
    if producer == "minkunet_plan":
        model = minkunet.MinkUNet34C(
            planes=tuple(p // 8 for p in minkunet.PLANES), init_dim=4,
            caps=(1024,) * minkunet.LEVELS, compute_dtype="float32")
        return model.plan(_small_table(), backward=True), {"stem"}, True
    backward = producer.endswith("train")
    packed = to_device(pack_pyramid(cfg, tiny_scene(4), backward=backward),
                       "cpu")
    return unpack_pyramid(cfg, packed, backward=backward), {"bev"}, backward


@pytest.mark.parametrize("producer", [
    "build_pyramid_serve", "build_pyramid_train", "plan_levels",
    "minkunet_plan", "unpack_pyramid_serve", "unpack_pyramid_train"])
def test_every_producer_gives_level_ordered_books(producer):
    pyr, extra, backward = _build(producer)
    assert set(pyr) == LEVELS | extra
    tables = pyr["tables"]
    n = len(tables)
    assert len(pyr["subm"]) == n and len(pyr["down"]) == len(pyr["up"]) \
        == n - 1 > 0
    books = pyr["subm"] + pyr["down"] + pyr["up"]
    books += [b for _, b in pyr.get("bev", {}).values()]
    books += [pyr["stem"]] if "stem" in pyr else []
    for b in books:
        assert isinstance(b, Book)
        assert (b.bwd is not None) == backward and b.halo is None
    for k, b in enumerate(pyr["subm"]):
        assert b.idx.shape == (27, tables[k].rows)
    for k, (down, up) in enumerate(zip(pyr["down"], pyr["up"])):
        kvol = down.idx.shape[0]
        assert down.idx.shape == (kvol, tables[k + 1].rows)
        assert up.idx.shape == (kvol, tables[k].rows)
        # up[k] reads level k + 1: its entries index that table's rows
        assert int(up.idx.max()) == tables[k + 1].rows
