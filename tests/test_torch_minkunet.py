"""MinkUNet34C on the CPU (models/minkunet.py) and what it brought to the
port's ops: kernel B's 5x5x5 column algorithm in plain PyTorch, row
masks and row orders of two words for books of 65 to 128 offsets, kernel
A's plain version over a 125-offset book, the per-voxel label rule,
``pad_scene``'s point labels and the segmentation model through
``Trainer.step``. The network is held against the benchmark's plain
float32 reference (perfbench/reference/minkunet.py) at its published
depth and an eighth of its widths; no JAX is involved.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from detection_3d_tpu_torch.config.defaults import CapacityConfig
from detection_3d_tpu_torch.engine.trainer import Trainer, pad_scene
from detection_3d_tpu_torch.models import minkunet
from detection_3d_tpu_torch.models.minkunet import (
    MinkUNet34C, MinkUNetConfig, segmentation_loss, voxel_labels)
from detection_3d_tpu_torch.ops.sparse import (
    build_sparse_tensor, neighbor_indices, neighbor_match_3x3x3,
    neighbor_match, neighbor_match_columns, submanifold_offsets)
from detection_3d_tpu_torch.ops.sparse_conv import (
    Book, gather_conv, masks_row_order, row_masks, rulebook_row_order,
    sparse_conv, weights_book)
from detection_3d_tpu_torch.utils.profiling import recorded_spans
from perfbench.reference import minkunet as ref
from perfbench.reference.config import (
    CapacityConfig as RefCaps, SolverConfig as RefSolver)
from perfbench.reference.solver import Solver as RefSolverLoop
from perfbench.traffic.box_labels import label_points
from torch_match_cases import MATCH_CASES

torch.set_num_threads(2)
SMALL = dict(planes=tuple(p // 8 for p in minkunet.PLANES), init_dim=4,
             voxel_full_scale=(48, 48, 32), compute_dtype="float32")


def _case_table(case):
    coords, spatial, cap, batch = MATCH_CASES[case]()
    coords = torch.from_numpy(coords)
    return build_sparse_tensor(coords, torch.zeros((coords.shape[0], 0)),
                               None, spatial, batch, cap)


def _unit():
    """Three stacked tables of 24 x 24 x 16 (one nearly empty)."""
    rng = np.random.RandomState(3)
    n = 1800
    coords = np.zeros((3, n, 4), np.int32)
    valid = np.zeros((3, n), bool)
    for b, m in enumerate((1800, 700, 5)):
        coords[b, :m, :3] = np.stack([rng.randint(0, s, m)
                                      for s in (24, 24, 16)], -1)
        valid[b, :m] = True
    return build_sparse_tensor(torch.from_numpy(coords),
                               torch.zeros((3, n, 0)),
                               torch.from_numpy(valid), (24, 24, 16), 1,
                               2048)


# -- kernel B's 5x5x5 column algorithm -------------------------------------

@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_5x5x5_columns_equal_neighbor_indices(case):
    """The column twin's 125-offset book is neighbor_indices over the
    5x5x5 offsets bit for bit, its masks row_masks of it (two words), on
    random, packed-edge, full-column, two-batch and ragged tables."""
    t = _case_table(case)
    book, masks = neighbor_match(t, radius=2)
    want = neighbor_indices(t, submanifold_offsets((5, 5, 5)))
    assert book.dtype == torch.int32 and torch.equal(book, want)
    assert masks.shape == (t.capacity, 2)
    assert torch.equal(masks, row_masks(want, t.capacity, t.row_valid))


def test_5x5x5_columns_on_a_unit():
    """A unit's book is flat (entries global, pad B * V) and each
    building's block equals its own table's book."""
    unit = _unit()
    nb, v = unit.units, unit.capacity
    book, masks = neighbor_match_columns(unit, radius=2)
    assert book.shape == (125, nb * v) and masks.shape == (nb * v, 2)
    for b in range(nb):
        one, m = neighbor_match_columns(unit.building(b), radius=2)
        assert torch.equal(book[:, b * v:(b + 1) * v],
                           torch.where(one < v, one + b * v, nb * v))
        assert torch.equal(masks[b * v:(b + 1) * v], m)


def test_3x3x3_callers_unchanged():
    """neighbor_match_3x3x3 on the CPU is still the radius-1 twin, equal
    to neighbor_indices over the 27 offsets, with one-word masks."""
    t = _case_table("edges")
    book, masks = neighbor_match_3x3x3(t)
    want = neighbor_indices(t, submanifold_offsets((3, 3, 3)))
    assert torch.equal(book, want) and masks.shape == (t.capacity,)
    assert torch.equal(masks, row_masks(want, t.capacity, t.row_valid))


# -- row masks and row orders -----------------------------------------------

def _old_masks(idx, v_in, valid):
    """The one-word masks as bits summed in int64."""
    real = (idx >= 0) & (idx < v_in) & valid[None, :]
    out = torch.zeros(idx.shape[1], dtype=torch.int64)
    for k in range(idx.shape[0]):
        out |= real[k].to(torch.int64) << k
    return out


@pytest.mark.parametrize("k", [1, 8, 27, 64, 65, 125])
def test_row_masks_and_order(k):
    """Masks of K <= 64 offsets are one int64 word a row, as before; of
    64 < K <= 128 two, bit k in word k // 64. The row order is a stable
    sort on the mask (low word first, then the high one): rows of equal
    masks keep their order, and the masks come out non-decreasing."""
    gen = torch.Generator().manual_seed(k)
    v_in, v_out = 50, 300
    idx = torch.randint(0, v_in + 8, (k, v_out), generator=gen,
                        dtype=torch.int32)
    idx[:, ::3] = v_in          # rows with few or no real entries
    valid = torch.rand(v_out, generator=gen) > 0.2
    masks = row_masks(idx, v_in, valid)
    real = (idx < v_in) & valid[None, :]
    if k <= 64:
        assert masks.shape == (v_out,)
        assert torch.equal(masks, _old_masks(idx, v_in, valid))
        words = masks[:, None]
    else:
        assert masks.shape == (v_out, 2)
        assert torch.equal(masks[:, 0], _old_masks(idx[:64], v_in, valid))
        assert torch.equal(masks[:, 1], _old_masks(idx[64:], v_in, valid))
        words = masks
    for kk in range(k):
        bit = (words[:, kk // 64] >> (kk % 64)) & 1
        assert torch.equal(bit.bool(), real[kk])
    order = rulebook_row_order(idx, v_in, valid)
    perm = order.perm.long()
    assert torch.equal(order.masks, masks[perm])
    assert sorted(perm.tolist()) == list(range(v_out))
    keys = [tuple(w[::-1]) for w in words[perm].tolist()]
    assert keys == sorted(keys)
    for a, b in zip(perm[:-1].tolist(), perm[1:].tolist()):
        if torch.equal(words[a], words[b]):
            assert a < b


# -- kernel A's plain version over 125 offsets --------------------------------

def test_plain_conv_125_offsets_matches_dense_conv():
    """gather_conv over the 5^3 book (with its two-word row order) is the
    dense 5^3 cross-correlation of the grid at the active sites (f64,
    1e-10: only the sum's order differs)."""
    spatial = (14, 12, 10)
    rng = np.random.RandomState(4)
    n = 500
    coords = np.stack([rng.randint(0, s, n) for s in spatial]
                      + [np.zeros(n, np.int64)], -1).astype(np.int32)
    feats = torch.from_numpy(rng.randn(n, 3))
    t = build_sparse_tensor(torch.from_numpy(coords), feats, None, spatial,
                            1, 512)
    book, masks = neighbor_match(t, radius=2)
    w = torch.from_numpy(rng.randn(125, 3, 4))
    got = gather_conv(t.feats, book, w, t.row_valid, masks_row_order(masks))
    grid = torch.zeros((1, 3) + spatial, dtype=torch.float64)
    m = int(t.num)
    c = t.coords[:m].long()
    grid[0, :, c[:, 0], c[:, 1], c[:, 2]] = t.feats[:m].T
    kernel = w.reshape(5, 5, 5, 3, 4).permute(4, 3, 0, 1, 2)
    dense = F.conv3d(grid, kernel, padding=2)[0]
    want = dense[:, c[:, 0], c[:, 1], c[:, 2]].T
    torch.testing.assert_close(got[:m], want, rtol=0, atol=1e-10)
    assert bool((got[m:] == 0).all())


def test_weights_book_gives_dw_alone():
    """The stem's backward book (weights_book): no transpose, and the
    conv's weight gradient through it equals the autograd of the plain
    conv's; asking for the input's gradient through it raises."""
    t = _case_table("dense")
    book, masks = neighbor_match(t, radius=2)
    bwd = weights_book(book, t.capacity, t.row_valid)
    assert bwd.t_idx is None and bwd.t_order is None
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((t.capacity, 3), generator=gen, dtype=torch.float64)
    w = torch.randn((125, 3, 5), generator=gen, dtype=torch.float64)
    g = torch.randn((t.capacity, 5), generator=gen, dtype=torch.float64)
    w1 = w.clone().requires_grad_()
    sparse_conv(x, Book(book, masks_row_order(masks), bwd), w1,
                t.row_valid).backward(g)
    w2 = w.clone().requires_grad_()
    gather_conv(x, book, w2, t.row_valid).backward(g)
    torch.testing.assert_close(w1.grad, w2.grad, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="no transpose"):
        sparse_conv(x.requires_grad_(), Book(book, None, bwd), w,
                    t.row_valid).backward(g)


# -- labels ----------------------------------------------------------------

def test_voxel_label_rule():
    """A voxel takes the label its points share; points that disagree,
    a point without a label (-1), a pad row and a point off the table
    (row_map == V) give -1 or do not count."""
    v = 6
    row_map = torch.tensor([0, 0, 1, 1, 2, 2, 3, 4, 6, 4])
    labels = torch.tensor([3, 3, 2, 4, 5, -1, -1, 1, 2, 1])
    row_valid = torch.tensor([True, True, True, True, True, False])
    got = voxel_labels(row_map, labels, row_valid)
    assert got.tolist() == [3, -1, -1, -1, 1, -1]


def test_box_labels_smallest_box_wins():
    """A point in two boxes takes the smaller one's label; a point half a
    voxel outside a box is in it, one a voxel outside is not; a point in
    no box, an invalid point and an invalid box give -1."""
    # yx_zb: xc, yc, z_bottom, y size, x size, z size, yaw - pi / 2; yaw
    # pi / 2 here, so the x size lies along x
    big = [2.0, 2.0, 0.0, 4.0, 4.0, 3.0, 0.0]
    small = [1.0, 1.0, 0.0, 0.5, 0.5, 1.0, 0.0]
    boxes = torch.tensor([big, small, small])
    blabels = torch.tensor([1, 3, 4], dtype=torch.int32)
    bvalid = torch.tensor([True, True, False])
    m = [[1.0, 1.0, 0.5], [3.0, 3.0, 1.0], [4.009, 2.0, 1.0],
         [4.02, 2.0, 1.0], [9.0, 9.0, 9.0], [1.0, 1.0, 0.5]]
    pts = torch.tensor(m) * 50
    pvalid = torch.tensor([True] * 5 + [False])
    got = label_points(pts, pvalid, boxes, blabels, bvalid)
    assert got.tolist() == [3, 1, 1, -1, -1, -1]


def test_pad_scene_carries_point_labels():
    rng = np.random.default_rng(0)
    cfg = MinkUNetConfig(caps=CapacityConfig(max_points=8, voxel_caps=(8,)
                                             * 5, max_gt=2))
    scene = {"points": rng.uniform(0, 5, (10, 3)).astype(np.float32),
             "feats": rng.uniform(0, 1, (10, 9)).astype(np.float32),
             "gt_boxes": np.zeros((1, 7), np.float32),
             "gt_labels": np.ones((1,), np.int32),
             "point_labels": np.arange(10, dtype=np.int32)}
    out = pad_scene(cfg, scene)
    assert out["feats"].shape == (8, 6)
    np.testing.assert_array_equal(out["point_labels"], np.arange(8))
    scene["points"], scene["point_labels"] = scene["points"][:5], \
        scene["point_labels"][:5]
    out = pad_scene(cfg, scene)
    np.testing.assert_array_equal(out["point_labels"],
                                  [0, 1, 2, 3, 4, -1, -1, -1])
    del scene["point_labels"]
    assert "point_labels" not in pad_scene(cfg, scene)


# -- the network against the reference -------------------------------------

def _scene(seed: int, n: int = 2600):
    """Points on three planes of a 48 x 48 x 32 grid (so that the 3^3 and
    5^3 books have neighbours), with labels 0..4 and some -1."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.5, 31.5, (n, 3)).astype(np.float32)
    third = n // 3
    pts[:third, 2] = 3.2
    pts[third:2 * third, 0] = 20.7
    pts[:, :2] *= 1.4
    return {"points": pts,
            "feats": rng.uniform(0, 1, (n, 9)).astype(np.float32),
            "gt_boxes": np.zeros((0, 7), np.float32),
            "gt_labels": np.zeros((0,), np.int32),
            "point_labels": rng.integers(-1, 5, n).astype(np.int32)}


def _pair(seed: int = 0):
    """(program config, program model, reference config, reference
    model) on the same float32 weights."""
    caps = dict(max_points=4096, voxel_caps=(4096,) * 5, max_gt=4)
    cfg = MinkUNetConfig(caps=CapacityConfig(**caps), **SMALL).validate()
    rcfg = ref.Config(caps=RefCaps(**caps), solver=RefSolver(),
                      **SMALL).validate()
    prog = MinkUNet34C.from_config(cfg, seed=seed)
    with torch.no_grad():     # non-trivial BN and classifier shifts
        gen = torch.Generator().manual_seed(seed + 1)
        for name, p in prog.named_parameters():
            if p.ndim == 1:
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    twin = ref.MinkUNet34C(rcfg)
    twin.load_state_dict(prog.state_dict(), strict=True)
    return cfg, prog, rcfg, twin


def test_published_depth_at_reduced_width():
    cfg, prog, _, _ = _pair()
    assert [len(getattr(prog, f"block{k}")) for k in range(1, 9)] == \
        list(minkunet.LAYERS)
    assert prog.conv0p1s1.w.shape == (125, 3, 4)
    assert prog.final.w.shape == (cfg.planes[7], 20)
    with torch.device("meta"):
        full = MinkUNet34C()
    assert sum(p.numel() for p in full.parameters()) == 37_856_052


def test_logits_loss_and_gradients_match_the_reference():
    """Logits, loss and every parameter's gradient of one building, the
    port (float32) against the reference. Tolerances: logits 1e-4 of the
    largest and the loss 1e-5 relative: the two sum in other orders (A's
    row order, BN's fixed tree against torch's batch_norm, index_add);
    gradients 1e-3 of each leaf's largest entry, since BN's backward
    subtracts nearly equal sums."""
    cfg, prog, rcfg, twin = _pair(3)
    batch = pad_scene(cfg, _scene(3))
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    table, labels = prog.voxelize(cfg, b["points"], b["feats"],
                                  b["points_valid"], b["point_labels"])
    level0, x, rlabels = ref.voxelize(rcfg, b["points"], b["feats"],
                                      b["points_valid"], b["point_labels"])
    m = int(table.num)
    assert m == level0.n > 1500
    assert torch.equal(labels[:m], rlabels) and int((labels >= 0).sum()) > 100
    logits = prog(table)
    want = twin(ref.plan(level0), x)
    torch.testing.assert_close(logits[:m], want, rtol=0,
                               atol=1e-4 * float(want.detach().abs().max()))
    loss = segmentation_loss(logits, labels)
    rloss = ref.segmentation_loss(want, rlabels)
    assert float(loss.detach()) == pytest.approx(float(rloss.detach()),
                                                 rel=1e-5)
    prog.zero_grad()
    twin.zero_grad()
    losses, dets, true_num = prog.training_losses(cfg, batch, "cpu")
    losses["loss_seg"].backward()
    rloss.backward()
    assert dets is None and int(true_num) == m
    grads = dict(twin.named_parameters())
    for name, p in prog.named_parameters():
        g = grads[name].grad
        torch.testing.assert_close(p.grad, g, rtol=0,
                                   atol=1e-3 * float(g.abs().max()) + 1e-9,
                                   msg=name)


@pytest.mark.parametrize("wants_input_grad", [True, False])
def test_reference_book_conv_backward_is_autograd(wants_input_grad):
    """The reference's written-out backward (BookConv) against autograd of
    the same gather, matmul and index_add, in float64 so that only the
    order of the sums differs (1e-12 relative)."""
    gen = torch.Generator().manual_seed(5)
    n_in, n_out, k = 40, 30, 5
    x = torch.randn(n_in, 3, generator=gen, dtype=torch.float64)
    w = torch.randn(k, 3, 4, generator=gen, dtype=torch.float64)
    book = [(torch.randint(0, n_in, (m,), generator=gen),
             torch.randint(0, n_out, (m,), generator=gen))
            for m in (17, 0, 33, 9, 50)]
    g = torch.randn(n_out, 4, generator=gen, dtype=torch.float64)

    def grads(conv):
        xs = x.clone().requires_grad_(wants_input_grad)
        ws = w.clone().requires_grad_(True)
        (conv(xs, ws) * g).sum().backward()
        return conv(xs, ws).detach(), xs.grad, ws.grad

    def plain(xs, ws):
        out = xs.new_zeros((n_out, 4))
        for (src, dst), wk in zip(book, ws):
            out = out.index_add(0, dst, xs[src] @ wk)
        return out

    got = grads(lambda xs, ws: ref.book_conv(xs, book, ws, n_out))
    want = grads(plain)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_slope_one_batch_norm_is_batch_norm_alone():
    """BNLeakyReLU at slope 1 (MinkUNet's BN without an activation) keeps
    negative outputs, as the same BN with no activation step would; slope
    0 still clips them."""
    from detection_3d_tpu_torch.ops.norm import batch_norm_leaky_relu
    gen = torch.Generator().manual_seed(2)
    feats = torch.randn(50, 6, generator=gen)
    valid = torch.arange(50) < 44
    scale = torch.rand(6, generator=gen) + 0.5
    bias = torch.randn(6, generator=gen)
    out = batch_norm_leaky_relu(feats, valid, scale, bias, 1.0, 1e-5)
    want = F.batch_norm(feats[:44], None, None, scale, bias, True, 0.0, 1e-5)
    torch.testing.assert_close(out[:44], want, rtol=1e-5, atol=1e-5)
    assert (out[:44] < 0).any() and (out[44:] == 0).all()
    relu = batch_norm_leaky_relu(feats, valid, scale, bias, 0.0, 1e-5)
    torch.testing.assert_close(relu[:44], want.clamp(min=0), rtol=1e-5,
                               atol=1e-5)


def test_trainer_step_matches_the_reference_step(tmp_path):
    """Two Trainer.step calls through pad_scene with point labels (the
    model's own loss method, the isfinite gate, the port's SGD) against
    the reference's steps with its solver: losses 1e-5 relative, every
    parameter within 1e-5 of its largest entry afterwards."""
    cfg, prog, rcfg, twin = _pair(5)
    trainer = Trainer(cfg, output_dir=str(tmp_path), device="cpu")
    state = trainer.init_state(model=prog)
    assert state.model.priority_shapes() == {}
    twin.train()
    solver = RefSolverLoop(rcfg, twin, 1)
    for s in (5, 6):
        scene = _scene(s)
        total, losses, ok, _ = trainer.step(state, pad_scene(cfg, scene),
                                            priorities={})
        want = ref.step(rcfg, twin, solver, ref.pad_scene(rcfg, scene),
                        "cpu")
        assert ok and set(losses) == {"loss_seg"}
        assert total == pytest.approx(want, rel=1e-5)
    for (name, p), q in zip(state.model.named_parameters(),
                            twin.parameters()):
        torch.testing.assert_close(p, q, rtol=0,
                                   atol=1e-5 * float(q.abs().max()) + 1e-9,
                                   msg=name)


def test_plan_span_attributes():
    """Under a profiler the forward opens model.plan (with the voxels of
    each level and the 5^3 book's real entries as attributes), stem,
    encoder, decoder and head; each attribute is read back as host
    numbers."""
    cfg, prog, _, _ = _pair(7)
    b = {k: torch.as_tensor(v) for k, v in
         pad_scene(cfg, _scene(7)).items()}
    table, _ = prog.voxelize(cfg, b["points"], b["feats"], b["points_valid"],
                             b["point_labels"])
    recorded_spans()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        prog(table)
    spans = {r.name: r for r in recorded_spans()}
    assert {"model.plan", "model.stem", "model.encoder", "model.decoder",
            "model.head"} <= set(spans)
    attrs = spans["model.plan"].attributes
    book = neighbor_match(table, radius=2)[0]
    assert attrs["voxels"][0] == int(table.num) and len(attrs["voxels"]) == 5
    assert attrs["voxels"] == sorted(attrs["voxels"], reverse=True)
    assert attrs["stem_pairs"] == int((book < table.capacity).sum())
    assert spans["model.stem"].attributes is None
