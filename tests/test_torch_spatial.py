"""Spatial sharding of one building (detection_3d_tpu_torch/parallel/
spatial.py) on gloo CPU ranks, against the JAX package's single-device
run with the same weights.

A small 4-scale config on a 128 x 128 x 64 grid (X divisible by 2 shards
x 8) whose capacities hold every voxel (a truncating cap subsamples a
shard's table otherwise than the whole building's), the tiny synthetic
buildings (walls on both sides of the x = 64 slab boundary), and halo
caps above the boundary columns' occupancy. Two ranks
(parallel/checks.spatial_job) run spatial_fpn_apply, spatial_predict,
make_spatial_grad_fn and make_spatial_train_step; four ranks on a
(dp, sp) = (2, 2) mesh run make_dp_spatial_grad_fn over two buildings
(parallel/checks.dp_spatial_job).

Tolerances (tests/test_spatial.py's): owned map rows within 2e-4,
losses within 1e-4, detections as sets with scores within 1e-3 and
boxes within 5e-3; gradients within atol 1e-5 + rtol 1e-3 of JAX's
single-device gradient (dp x sp: of the mean over the two buildings,
each with JAX's dp-folded key ``fold_in(rng, d)``). The overflow flag
is raised under caps below the occupancy. The slow test holds every
extended table, halo index and book of the port's pyramid bit for bit
against JAX's build_spatial_pyramid under shard_map.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from detection_3d_tpu.config import defaults as jdefaults
from detection_3d_tpu.models.backbone import (
    SparseFPN as JFPN, build_pyramid as jpyramid)
from detection_3d_tpu.models.detector import (
    SparseRCNN as JRCNN, voxelize_points as jvox)
from detection_3d_tpu.models.structures import Boxes3D as JBoxes3D
from detection_3d_tpu_torch.config import defaults as tdefaults
from detection_3d_tpu_torch.engine.trainer import pad_scene
from detection_3d_tpu_torch.models.detector import SparseRCNN
from detection_3d_tpu_torch.parallel.checks import (
    dp_spatial_job, spatial_job)
from detection_3d_tpu_torch.parallel.mesh import launch
from detection_3d_tpu_torch.utils.convert import convert_jax_params
from test_torch_common import tiny_cfg, tiny_scene, to_numpy_tree

SHARD_CAPS = (4096, 4096, 2048, 1024)
HALO_CAPS = (64, 64, 64, 32)      # boundary columns hold <= 24 sites
SMALL_HALO_CAPS = (2, 2, 2, 2)
LOSS_NAMES = ("loss_objectness", "loss_rpn_box_reg", "loss_classifier_roi",
              "loss_box_reg_roi")


def spatial_cfg(mod):
    return tiny_cfg(
        mod,
        sparse3d=mod.Sparse3DConfig(
            voxel_scale=20, voxel_full_scale=(128, 128, 64),
            nplanes_front=(8, 16, 16, 32), kernels=((2, 2, 2),) * 3,
            strides=((2, 2, 2),) * 3, nplane_map=16),
        caps=mod.CapacityConfig(max_points=8192,
                                voxel_caps=(8192, 8192, 4096, 2048),
                                max_gt=16))


def _rows(t):
    v = np.asarray(t.row_valid)
    return np.asarray(t.coords)[v], np.asarray(t.feats)[v]


@pytest.fixture(scope="module")
def ref():
    """JAX single-device references: the FPN maps and detections of
    building 0, and each building's losses and gradients with key
    fold_in(rng, i), with the samplers' draws for the port."""
    jcfg, tcfg = spatial_cfg(jdefaults), spatial_cfg(tdefaults)
    batches = [pad_scene(tcfg, tiny_scene(s)) for s in (0, 1)]
    jbs = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    rng = jax.random.PRNGKey(11)
    model = JRCNN(jcfg)
    table0 = jvox(jcfg, jbs[0]["points"], jbs[0]["feats"],
                  jbs[0]["points_valid"])
    params = jax.jit(functools.partial(model.init, is_train=True))(
        rng, table0, JBoxes3D(jbs[0]["gt_boxes"], jbs[0]["gt_valid"]),
        jbs[0]["gt_labels"], rng=rng)
    pyr = jpyramid(table0, jcfg)
    assert all(int(t.true_num) <= t.capacity for t in pyr["tables"])
    rpn, roi = JFPN(jcfg).apply(
        {"params": params["params"]["backbone"]}, table0, pyr)
    det = jax.jit(functools.partial(model.apply, is_train=False))(
        params, table0)

    @jax.jit
    def grads_of(params, b, key):
        def loss_fn(p):
            table = jvox(jcfg, b["points"], b["feats"], b["points_valid"])
            losses, _ = model.apply(
                p, table, JBoxes3D(b["gt_boxes"], b["gt_valid"]),
                b["gt_labels"], is_train=True, rng=key)
            return sum(jax.tree_util.tree_leaves(losses)), losses
        return jax.value_and_grad(loss_fn, has_aux=True)(params)

    shapes = SparseRCNN(tcfg).priority_shapes()
    per, pri = [], []
    for i, jb in enumerate(jbs):
        key = jax.random.fold_in(rng, i)
        (total, losses), g = grads_of(params, jb, key)
        per.append({"total": float(total),
                    "losses": {k: float(v) for k, v in losses.items()},
                    "grads": convert_jax_params(to_numpy_tree(g))})
        pri.append({"rpn": np.array(jax.random.uniform(
                        jax.random.fold_in(key, 0), (shapes["rpn"],))),
                    "roi": np.array(jax.random.uniform(
                        jax.random.fold_in(key, 1000), (shapes["roi"],)))})
    v = np.asarray(det.valid)
    state = {k: t.numpy() for k, t in SparseRCNN(tcfg).load_jax_params(
        to_numpy_tree(params)).state_dict().items()}
    return {"cfg": tcfg, "batches": batches, "priorities": pri,
            "state": state, "rpn": [_rows(m) for m in rpn],
            "roi": [_rows(m) for m in roi], "per": per,
            "det": {"boxes": np.asarray(det.boxes)[v],
                    "scores": np.asarray(det.fields["scores"])[v],
                    "labels": np.asarray(det.fields["labels"])[v]}}


@pytest.fixture(scope="module")
def sp2(ref, tmp_path_factory):
    init = str(tmp_path_factory.mktemp("dist") / "sp2")
    return launch(spatial_job, 2, "gloo", init, args=(
        ref["cfg"], ref["state"], ref["batches"][0], ref["priorities"][0],
        SHARD_CAPS, HALO_CAPS, SMALL_HALO_CAPS))


@pytest.fixture(scope="module")
def dp2sp2(ref, tmp_path_factory):
    init = str(tmp_path_factory.mktemp("dist") / "dpsp")
    return launch(dp_spatial_job, 4, "gloo", init, args=(
        ref["cfg"], ref["state"], ref["batches"], ref["priorities"], 2,
        SHARD_CAPS, HALO_CAPS))


@pytest.mark.parametrize("kind,i", [("roi", 0), ("roi", 1), ("rpn", 0),
                                    ("rpn", 1), ("rpn", 2)])
def test_owned_fpn_rows_match_jax(ref, sp2, kind, i):
    """Every map row of the single-device run is owned by exactly one
    shard, with the same features (rpn 2 is a BEV map)."""
    coords, feats = ref[kind][i]
    want = {tuple(c): f for c, f in zip(coords, feats)}
    seen = set()
    for out in sp2:
        rows = out[f"{kind}_rows"][i]
        for c, f in zip(rows["coords"], rows["feats"]):
            c = tuple(c)
            assert c in want and c not in seen, c
            seen.add(c)
            np.testing.assert_allclose(f, want[c], rtol=2e-4, atol=2e-4,
                                       err_msg=str(c))
    assert len(seen) == len(want)
    # both shards own rows next to the slab boundary
    assert all(len(out[f"{kind}_rows"][i]["coords"]) for out in sp2)


def test_spatial_predict_matches_jax(ref, sp2):
    want = ref["det"]
    ro = np.lexsort((want["scores"], want["labels"]))
    for out in sp2:
        got = out["det"]
        assert got["scores"].shape == want["scores"].shape
        so = np.lexsort((got["scores"], got["labels"]))
        np.testing.assert_array_equal(got["labels"][so], want["labels"][ro])
        np.testing.assert_allclose(got["scores"][so], want["scores"][ro],
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got["boxes"][so], want["boxes"][ro],
                                   rtol=1e-3, atol=5e-3)
    for k in ("boxes", "scores", "labels"):     # every shard the same
        np.testing.assert_array_equal(sp2[0]["det"][k], sp2[1]["det"][k])


@pytest.mark.parametrize("name", ("total",) + LOSS_NAMES)
def test_spatial_losses_match_jax(ref, sp2, name):
    want = ref["per"][0]
    for out in sp2:
        got = out["total"] if name == "total" else out["losses"][name]
        w = want["total"] if name == "total" else want["losses"][name]
        np.testing.assert_allclose(got, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("part", ["backbone", "rpn", "roi_head"])
def test_spatial_gradients_match_jax(ref, sp2, part):
    want = ref["per"][0]["grads"]
    names = [n for n in want if n.startswith(part + ".")]
    assert names
    for out in sp2:
        assert bool(out["ok"])
        for n in names:
            np.testing.assert_allclose(out["grads"][n], want[n].numpy(),
                                       rtol=1e-3, atol=1e-5, err_msg=n)


def test_spatial_step_applies_alike_on_every_shard(ref, sp2):
    for out in sp2:
        assert bool(out["step_ok"])
    moved = 0
    for n, p in sp2[0]["params"].items():
        np.testing.assert_array_equal(p, sp2[1]["params"][n], err_msg=n)
        moved += int(not np.array_equal(p, ref["state"][n]))
    assert moved > 0


def test_halo_overflow_is_flagged(sp2):
    for out in sp2:
        assert not any(bool(f) for f in out["overflow"])
        assert bool(out["small_overflow"])


@pytest.mark.parametrize("part", ["backbone", "rpn", "roi_head"])
def test_dp_spatial_gradients_match_jax_mean(ref, dp2sp2, part):
    per = ref["per"]
    names = [n for n in per[0]["grads"] if n.startswith(part + ".")]
    for out in dp2sp2:
        assert bool(out["ok"]) and not bool(out["overflow"])
        for n in names:
            want = (per[0]["grads"][n] + per[1]["grads"][n]).numpy() / 2
            np.testing.assert_allclose(out["grads"][n], want, rtol=1e-3,
                                       atol=1e-5, err_msg=n)


def test_dp_spatial_losses_and_step(ref, dp2sp2):
    per = ref["per"]
    assert [out["coords"] for out in dp2sp2] == [
        {"dp": d, "sp": s} for d in (0, 1) for s in (0, 1)]
    for out in dp2sp2:
        np.testing.assert_allclose(out["total"], np.mean(
            [p["total"] for p in per]), rtol=1e-4, atol=1e-4)
        for k in LOSS_NAMES:
            np.testing.assert_allclose(out["losses"][k], np.mean(
                [p["losses"][k] for p in per]), rtol=1e-4, atol=1e-4)
        assert bool(out["step_ok"])
        for n, p in out["params"].items():
            np.testing.assert_array_equal(p, dp2sp2[0]["params"][n])


def test_synced_bn_matches_jax_over_the_concatenated_rows(tmp_path):
    """BN with its statistics summed over 2 ranks (ops/norm.py's
    process_group) equals JAX's batch_norm_leaky_relu over both ranks'
    rows: the output, the rows' gradients, and the parameters'
    gradients summed over the ranks."""
    from detection_3d_tpu.ops.norm import batch_norm_leaky_relu as jbn
    from detection_3d_tpu_torch.parallel.checks import synced_bn_job
    rng = np.random.RandomState(4)
    feats = [rng.randn(n, 6).astype(np.float32) * 2 + 1 for n in (40, 25)]
    valid = [rng.rand(n) < 0.8 for n in (40, 25)]
    cts = [rng.randn(n, 6).astype(np.float32) for n in (40, 25)]
    scale = rng.rand(6).astype(np.float32) + 0.5
    bias = rng.randn(6).astype(np.float32)
    res = launch(synced_bn_job, 2, "gloo", str(tmp_path / "init"),
                 args=(feats, valid, scale, bias, cts))
    x, v, ct = (jnp.asarray(np.concatenate(a)) for a in (feats, valid, cts))
    out, vjp = jax.vjp(lambda x, s, b: jbn(x, v, s, b), x,
                       jnp.asarray(scale), jnp.asarray(bias))
    d_x, d_s, d_b = vjp(ct)
    np.testing.assert_allclose(np.concatenate([r["out"] for r in res]),
                               np.asarray(out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["d_feats"] for r in res]),
                               np.asarray(d_x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(r["d_scale"] for r in res),
                               np.asarray(d_s), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(r["d_bias"] for r in res),
                               np.asarray(d_b), rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_spatial_pyramid_bit_exact_vs_jax(ref, tmp_path):
    """Every extended table (coords and keys), own mask, halo exchange
    index, submanifold, strided and deconv book and BEV table and book
    of the port's shard pyramids against JAX's build_spatial_pyramid
    under shard_map on 2 CPU devices. The overflow flags differ by
    design: JAX also counts the grid's outer faces (here the wall at
    x = 0, which no neighbour receives), the port only the columns a
    neighbour receives."""
    from jax.sharding import Mesh as JMesh, PartitionSpec as P
    from detection_3d_tpu.parallel.spatial import build_spatial_pyramid
    from detection_3d_tpu_torch.parallel.checks import spatial_pyramid_job
    jcfg = spatial_cfg(jdefaults)
    batch = ref["batches"][0]
    halo_fields = ("send_lo", "send_lo_ok", "send_hi", "send_hi_ok",
                   "recv_lo", "recv_lo_ok", "recv_hi", "recv_hi_ok")

    def run(points, feats, valid):
        pyr = build_spatial_pyramid(jcfg, points, feats, valid, "sp", 2,
                                    SHARD_CAPS, HALO_CAPS)

        def fields(t):
            return {"coords": t.coords, "hi": t.hi, "lo": t.lo,
                    "num": t.num}
        out = {"tables": [fields(t) for t in pyr["tables"]],
               "own_valid": pyr["own_valid"],
               "halos": [{f: getattr(e["halo"], f) for f in halo_fields}
                         for e in pyr["subm_idx"]],
               "subm_idx": [e["idx"] for e in pyr["subm_idx"]],
               "down_rb": [e["idx"] for e in pyr["down_rb"]],
               "up_rb": [e["idx"] for e in pyr["up_rb"]],
               "bev": {s: (fields(t), rb) for s, (t, rb) in
                       pyr["bev"].items()},
               "overflow": pyr["halo_overflow"]}
        return jax.tree.map(lambda a: jnp.asarray(a)[None], out)

    mesh = JMesh(np.array(jax.devices()[:2]), ("sp",))
    want = jax.shard_map(run, mesh=mesh, in_specs=(P(), P(), P()),
                         out_specs=P("sp"))(
        *(jnp.asarray(batch[k]) for k in ("points", "feats",
                                          "points_valid")))
    got = launch(spatial_pyramid_job, 2, "gloo", str(tmp_path / "init"),
                 args=(ref["cfg"], batch, SHARD_CAPS, HALO_CAPS))
    for d, out in enumerate(got):
        assert not bool(out.pop("overflow"))
        assert bool(np.asarray(want["overflow"])[0])    # the x = 0 wall
        flat_w = jax.tree_util.tree_leaves_with_path(jax.tree.map(
            lambda a: np.asarray(a)[d],
            {k: v for k, v in want.items() if k != "overflow"}))
        flat_g = dict(jax.tree_util.tree_leaves_with_path(out))
        assert len(flat_w) == len(flat_g)
        for path, w in flat_w:
            g = flat_g[path]
            np.testing.assert_array_equal(
                np.asarray(g).astype(w.dtype), w,
                err_msg=f"shard {d} {jax.tree_util.keystr(path)}")


def test_three_shards_one_of_them_empty(tmp_path):
    """3 x-slabs of a 192-wide grid, the building in the first two: the
    empty third shard takes part in every exchange, and the owned rows
    equal the port's single-device maps (itself held against JAX by
    tests/test_torch_backbone.py) with no overflow under caps that hold
    the x = 122 wall's column at scale 3 (Y_3 * Z_3 = 128)."""
    import dataclasses
    import torch
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.models.detector import voxelize_points
    cfg = spatial_cfg(tdefaults)
    cfg = cfg.replace(sparse3d=dataclasses.replace(
        cfg.sparse3d, voxel_full_scale=(192, 128, 64)))
    batch = pad_scene(cfg, tiny_scene(0))
    model = SparseRCNN(cfg, seed=0)
    with torch.no_grad():
        table = voxelize_points(cfg, *(torch.as_tensor(batch[k]) for k in
                                       ("points", "feats", "points_valid")))
        _, roi = model.backbone(table, build_pyramid(table, cfg))
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    res = launch(spatial_job, 3, "gloo", str(tmp_path / "init"), args=(
        cfg, state, batch, None, SHARD_CAPS, HALO_CAPS[:3] + (128,),
        SMALL_HALO_CAPS))
    for i, m in enumerate(roi):
        v = m.row_valid.numpy()
        want = {tuple(c): f for c, f in zip(m.coords.numpy()[v],
                                            m.feats.numpy()[v])}
        counts = [len(out["roi_rows"][i]["coords"]) for out in res]
        assert counts[2] == 0 and sum(counts) == len(want)
        for out in res:
            rows = out["roi_rows"][i]
            for c, f in zip(rows["coords"], rows["feats"]):
                np.testing.assert_allclose(f, want[tuple(c)], rtol=2e-4,
                                           atol=2e-4)
    for out in res:
        assert not any(bool(f) for f in out["overflow"])
        assert out["det"]["scores"].shape == res[0]["det"]["scores"].shape


def test_shard_backward_books_are_not_the_reversed_book(tmp_path):
    """On an extended table a submanifold book is not its own transpose
    read with reversed offsets (the single-device pyramid's shortcut):
    the reversed book also sends halo rows' gradients back from halo
    rows, which are no conv's output. The transpose over own outputs is
    the reversed book with every non-own target dropped, so the shard
    pyramid takes its backward books from the transposing scatter."""
    import torch
    from detection_3d_tpu_torch.ops.sparse_conv import transpose_rulebook
    from detection_3d_tpu_torch.parallel.checks import spatial_pyramid_job
    cfg = spatial_cfg(tdefaults)
    res = launch(spatial_pyramid_job, 2, "gloo", str(tmp_path / "init"),
                 args=(cfg, pad_scene(cfg, tiny_scene(0)), SHARD_CAPS,
                       HALO_CAPS))
    differ = 0
    for out in res:
        for idx, own in zip(out["subm_idx"], out["own_valid"]):
            idx, own = torch.from_numpy(idx), torch.from_numpy(own)
            v = idx.shape[1]
            t, _ = transpose_rulebook(idx, v, own)
            rev = idx.flip(0)
            target_own = torch.cat([own, torch.zeros(1, dtype=torch.bool)])
            want = torch.where(target_own[rev.long()], rev, v)
            assert torch.equal(t, want)
            differ += int((t != rev).sum())
    assert differ > 0
