"""One forward over a unit of B buildings (the port of the JAX package's
vmaps), on the CPU.

1. make_batch_predict_fn against the JAX package's vmapped
   make_batch_predict_fn, with the same (converted) weights: the table,
   pyramid and points forms of the default model and the table form of
   3G6c, at B = 2 and 3. Every unit holds a building that overflows its
   scale-0 capacity, and one unit is a padded tail. ``true_num`` is
   equal per building and the valid detections are the same set within
   1e-4 (JAX at B = 3; vmap gives each building what it gives alone).
   The same units are bit equal to the port's per-building predict.
2. The stacked table-building ops against B single calls, bit for bit:
   build_sparse_tensor (an overflowing building among them), kernel B's
   plain version, the downsample and BEV books; the searched conv and
   deconv books of a unit equal to its scatter-derived ones.
3. postprocess of a unit against JAX's postprocess of each building,
   within 1e-4; roi_align of a unit against JAX's per building, a
   missing corner reading JAX's zero pad row even where the row the
   port read before holds inf.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from detection_3d_tpu.data import pyramid_packing as jpyr
from detection_3d_tpu.engine.inference import (
    make_batch_predict_fn as j_batch_fn,
)
from detection_3d_tpu.models.detector import SparseRCNN as JRCNN
from detection_3d_tpu.models.roi_head import postprocess as j_postprocess
from detection_3d_tpu.models.structures import Boxes3D as JBoxes3D
from detection_3d_tpu.ops.roi_align import (
    roi_align_rotated_sparse as j_roi_align,
)
from detection_3d_tpu_torch.data.packing import pack_scene, pack_table
from detection_3d_tpu_torch.data.pyramid_packing import pack_pyramid
from detection_3d_tpu_torch.data.synthetic import synthetic_building
from detection_3d_tpu_torch.engine.inference import (
    make_batch_predict_fn, make_predict_fn,
)
from detection_3d_tpu_torch.models.backbone import bev_with_rulebook
from detection_3d_tpu_torch.models.detector import SparseRCNN
from detection_3d_tpu_torch.models.roi_head import postprocess
from detection_3d_tpu_torch.models.structures import Boxes3D
from detection_3d_tpu_torch.ops.roi_align import roi_align_rotated_sparse
from detection_3d_tpu_torch.ops.sparse import (
    build_sparse_tensor, conv_rulebook, downsample_with_rulebooks,
    neighbor_match_columns,
)
from detection_3d_tpu_torch.ops.sparse_conv import deconv_rulebook
from test_torch_common import (
    CLASSES4, cfg_pair, random_coords, scene_tables, table_pair,
    to_numpy_tree,
)
from test_torch_separate_classifier import CLASSES6, sep_pair

PACKERS = {True: pack_scene, "table": pack_table, "pyramid": pack_pyramid}
# (model, form) cases; the JAX reference runs once per case at B = 3
CASES = [("default", True), ("default", "table"), ("default", "pyramid"),
         ("3g6c", "table")]
# the buildings of each B: every unit holds an overflowing building (a
# 6000-point scene has ~5200 voxels over the scale-0 capacity 4096), and
# the last unit is padded by repeating its last building
BIG, SMALL = 6000, 2500
SCENES = (BIG, SMALL, SMALL, BIG, SMALL)
UNITS = {3: [[0, 1, 2], [3, 4, 4]], 2: [[0, 1], [3, 3]]}


def _scene(model, i):
    classes = CLASSES6 if model == "3g6c" else CLASSES4
    return synthetic_building(seed=10 + i, num_points=SCENES[i], room=6.0,
                              classes=classes, voxel_scale=20)


def _valid_rows(packed):
    a = np.asarray(packed)
    a = a[a[:, 9] > 0.5]
    return a[np.lexsort((a[:, 7], a[:, 8]))]


def _stack(packs):
    return {k: np.stack([p[k] for p in packs]) for k in packs[0]}


@pytest.fixture(scope="module")
def models():
    """{model: (JAX cfg, port cfg, JAX params, port model)}, the port
    model loaded with the JAX params."""
    out = {}
    for name, (jcfg, tcfg) in (("default", cfg_pair()),
                               ("3g6c", sep_pair())):
        jt, _ = scene_tables(jcfg, tcfg, _scene(name, 1))
        params = to_numpy_tree(jax.jit(
            lambda k, c=jcfg: JRCNN(c).init(k, jt, is_train=False))(
                jax.random.PRNGKey(0)))
        out[name] = (jcfg, tcfg, params,
                     SparseRCNN(tcfg).load_jax_params(params))
    return out


@pytest.fixture(scope="module")
def jax_outputs(models):
    """{(model, form): [(packed (K, 10), true_num) per building]} from
    JAX's vmapped predict over the B = 3 units."""
    cache = {}

    def get(model, form):
        if (model, form) not in cache:
            jcfg, tcfg, params, _ = models[model]
            scenes = [_scene(model, i) for i in range(len(SCENES))]
            if form == "pyramid":
                packs = [jpyr.pack_pyramid(jcfg, s) for s in scenes]
            else:
                packs = [PACKERS[form](tcfg, s) for s in scenes]
            predict = j_batch_fn(jcfg, packed=form)
            got = {}
            for unit in UNITS[3]:
                stacked = {k: jnp.asarray(v) for k, v in
                           _stack([packs[i] for i in unit]).items()}
                out, true_num = predict(params, stacked)
                for b, i in enumerate(unit):
                    got[i] = (np.asarray(out[b]), int(true_num[b]))
            cache[model, form] = got
        return cache[model, form]
    return get


@pytest.fixture(scope="module")
def port_singles(models):
    """{(model, form): the packs, and the port's per-building predict of
    each (packed (K, 10), true_num)}."""
    cache = {}

    def get(model, form):
        if (model, form) not in cache:
            _, tcfg, _, port = models[model]
            packs = [PACKERS[form](tcfg, _scene(model, i))
                     for i in range(len(SCENES))]
            one = make_predict_fn(tcfg, port, device="cpu", packed=form)
            cache[model, form] = packs, [one(p) for p in packs]
        return cache[model, form]
    return get


@pytest.mark.parametrize("units", [2, 3])
@pytest.mark.parametrize("model,form", CASES)
def test_batch_predict_matches_jax_vmap(models, jax_outputs, port_singles,
                                        model, form, units):
    jcfg, tcfg, _, port = models[model]
    want = jax_outputs(model, form)
    packs, singles = port_singles(model, form)
    predict = make_batch_predict_fn(tcfg, port, device="cpu", packed=form)
    overflowed = 0
    for unit in UNITS[units]:
        out, true_num = predict(_stack([packs[i] for i in unit]))
        assert out.shape == (units, tcfg.roi_detections_per_img
                             * port.groups, 10)
        assert true_num.shape == (units,)
        cap0 = tcfg.caps.scale_caps(tcfg.sparse3d.num_scales)[0]
        overflowed += int((true_num > cap0).any())
        for b, i in enumerate(unit):
            j_out, j_true = want[i]
            assert int(true_num[b]) == j_true
            w, g = _valid_rows(j_out), _valid_rows(out[b].numpy())
            assert w.shape[0] > 0 and g.shape == w.shape, (i, g.shape)
            np.testing.assert_array_equal(g[:, 8], w[:, 8])
            np.testing.assert_allclose(g[:, :8], w[:, :8], atol=1e-4,
                                       rtol=0)
            o, t = singles[i]
            assert torch.equal(out[b], o) and int(t) == int(true_num[b])
    assert overflowed == len(UNITS[units])


# ---- the table-building ops of a unit --------------------------------------


SPATIAL = (32, 24, 16)


def _unit_inputs(ns=(900, 3000, 1500), seed=0):
    """Stacked random coords (one building above the capacity 2048) with
    feats, and the valid rows, padded to one length."""
    n = max(ns)
    coords, feats, valid = [], [], []
    for b, m in enumerate(ns):
        c = np.zeros((n, 4), np.int32)
        c[:m] = random_coords(m, SPATIAL, seed + b)
        coords.append(c)
        feats.append(np.random.RandomState(seed + b).rand(n, 3)
                     .astype(np.float32))
        valid.append(np.arange(n) < m)
    return (torch.from_numpy(np.stack(coords)),
            torch.from_numpy(np.stack(feats)),
            torch.from_numpy(np.stack(valid)))


def test_stacked_tables_and_books_bit_equal_single_calls():
    coords, feats, valid = _unit_inputs()
    nb, cap = coords.shape[0], 2048
    unit, row_map = build_sparse_tensor(coords, feats, valid, SPATIAL, 1, cap,
                                        return_row_map=True)
    assert unit.batched and unit.num.shape == (nb,)
    singles = [build_sparse_tensor(coords[b], feats[b], valid[b], SPATIAL, 1,
                                   cap, return_row_map=True)
               for b in range(nb)]
    assert int(unit.true_num.max()) > cap       # a building overflowed
    for b, (t, rm) in enumerate(singles):
        for f in ("coords", "feats", "hi", "lo", "keys", "num", "true_num"):
            assert torch.equal(getattr(unit, f)[b], getattr(t, f)), f
        assert torch.equal(row_map[b], rm)

    def flat(books, v_in):
        """Single books side by side, their entries made global."""
        return torch.cat([torch.where(bk < v_in, bk + b * v_in, nb * v_in)
                          for b, bk in enumerate(books)], 1).int()

    idx, masks = neighbor_match_columns(unit)
    ones = [neighbor_match_columns(t) for t, _ in singles]
    assert torch.equal(idx, flat([i for i, _ in ones], cap))
    assert torch.equal(masks, torch.cat([m for _, m in ones]))

    down, crb, drb = downsample_with_rulebooks(unit, (2, 2, 2), (2, 2, 2),
                                               1024)
    outs = [downsample_with_rulebooks(t, (2, 2, 2), (2, 2, 2), 1024)
            for t, _ in singles]
    for b, (t, c, d) in enumerate(outs):
        assert torch.equal(down.coords[b], t.coords)
        assert torch.equal(down.num[b], t.num)
    assert torch.equal(crb, flat([c for _, c, _ in outs], cap))
    assert torch.equal(drb, flat([d for _, _, d in outs], 1024))
    # the searched books of the unit equal its scatter-derived ones
    assert torch.equal(conv_rulebook(down, unit, (2, 2, 2), (2, 2, 2)), crb)
    assert torch.equal(deconv_rulebook(unit, down, (2, 2, 2), (2, 2, 2)),
                       drb)

    bev, brb = bev_with_rulebook(unit, cap)
    bevs = [bev_with_rulebook(t, cap) for t, _ in singles]
    for b, (t, rb) in enumerate(bevs):
        assert torch.equal(bev.coords[b], t.coords)
    assert torch.equal(brb, flat([rb for _, rb in bevs], cap))


def test_stacked_table_matches_jax_per_building():
    coords, feats, valid = _unit_inputs(seed=3)
    unit = build_sparse_tensor(coords, feats, valid, SPATIAL, 1, 2048)
    for b in range(coords.shape[0]):
        jt, _ = table_pair(coords[b].numpy(), feats[b].numpy(), SPATIAL,
                           2048, valid=valid[b].numpy())
        np.testing.assert_array_equal(unit.coords[b].numpy(),
                                      np.asarray(jt.coords))
        assert int(unit.num[b]) == int(jt.num)
        assert int(unit.true_num[b]) == int(jt.true_num)
        np.testing.assert_allclose(unit.feats[b].numpy(),
                                   np.asarray(jt.feats), atol=1e-6, rtol=1e-6)


# ---- postprocess and roi_align of a unit against JAX -----------------------


def test_postprocess_of_a_unit_matches_jax():
    _, tcfg = cfg_pair()
    jcfg, _ = cfg_pair()
    rng = np.random.RandomState(4)
    nb, r, nc = 2, 64, tcfg.num_classes
    centers = rng.uniform(0, 4, (nb, r, 3))
    boxes = np.concatenate([centers, rng.uniform(0.2, 2, (nb, r, 3)),
                            rng.uniform(-1.5, 1.5, (nb, r, 1))],
                           -1).astype(np.float32)
    boxes[:, 20:30] = boxes[:, 20:21]            # duplicates
    valid = rng.rand(nb, r) > 0.2
    logits = rng.randn(nb, r, nc).astype(np.float32) * 3
    reg = (rng.randn(nb, r, nc * 7) * 0.1).astype(np.float32)
    det = postprocess(tcfg, Boxes3D(torch.from_numpy(boxes),
                                    torch.from_numpy(valid)),
                      torch.from_numpy(logits), torch.from_numpy(reg), nc,
                      tcfg.roi_detections_per_img)
    for b in range(nb):
        jd = j_postprocess(jcfg, JBoxes3D(jnp.asarray(boxes[b]),
                                          jnp.asarray(valid[b])),
                           jnp.asarray(logits[b]), jnp.asarray(reg[b]), nc,
                           jcfg.roi_detections_per_img)
        want = np.c_[np.asarray(jd.boxes), np.asarray(jd.fields["scores"]),
                     np.asarray(jd.fields["labels"])][np.asarray(jd.valid)]
        got = np.c_[det.boxes[b].numpy(), det.fields["scores"][b].numpy(),
                    det.fields["labels"][b].numpy()][det.valid[b].numpy()]
        assert want.shape[0] > 0 and got.shape == want.shape
        np.testing.assert_array_equal(got[:, 8], want[:, 8])
        np.testing.assert_allclose(got[:, :8], want[:, :8], atol=1e-4,
                                   rtol=0)


def test_roi_align_reads_a_zero_pad_row_as_jax():
    """A missing corner reads the appended zero row: the row the port's
    modulo-V spread read before (sample position % V) holds inf and
    pooling still equals JAX's; a unit's rois each pool from their own
    building (the unit is the same table twice, the inf in the second)."""
    coords, feats, valid = _unit_inputs(ns=(1500, 1500), seed=7)
    coords[1], feats[1], valid[1] = coords[0], feats[0], valid[0]
    unit = build_sparse_tensor(coords, feats, valid, SPATIAL, 1, 2048)
    clean = unit.feats.clone()
    unit.feats[1, 0] = float("inf")       # position 0's spread row
    unit.feats[1, -1] = float("inf")      # a pad row
    rng = np.random.RandomState(2)
    r = 6
    rois = np.c_[rng.uniform(4, 20, (r, 3)), rng.uniform(2, 6, (r, 3)),
                 rng.uniform(-1, 1, (r, 1))].astype(np.float32)
    rois[0, :3] = (-3, -3, -3)            # mostly outside: missing corners
    roi_valid = np.ones(r, bool)
    jt, _ = table_pair(coords[0].numpy(), feats[0].numpy(), SPATIAL, 2048,
                       valid=valid[0].numpy())
    want = np.asarray(j_roi_align(jt, jnp.asarray(rois),
                                  jnp.asarray(roi_valid), (2, 2, 2), 2))
    got = roi_align_rotated_sparse(
        unit, torch.from_numpy(np.stack([rois, rois])),
        torch.from_numpy(np.stack([roi_valid, roi_valid])), (2, 2, 2), 2)
    assert torch.equal(unit.feats[0], clean[0])
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=0)
    # building 1's inf rows: a missing corner never reads them
    assert bool(torch.isfinite(got[1, 0]).all())
    np.testing.assert_allclose(got[1, 0].numpy(), want[0], atol=1e-5, rtol=0)
