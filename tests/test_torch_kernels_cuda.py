"""The port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of JAX,
so it runs on a machine without it (tests/conftest.py imports JAX, so
skip it there):

    python -m pytest --noconftest -p no:randomly -q tests/test_torch_kernels_cuda.py

Tolerances: kernels B (its book and row masks), C and D are bit exact
(C: every float32 bit, two NaNs counted equal), B also with a
shared-memory window so small that it searches in global memory; kernel
A and the backward (dFeats through kernel A on the transposed book, the
dW kernel) within 1e-4 of the
largest output in f32 (sum order) and 1e-2 in bf16 (one bf16 rounding
of the f32 sum). The backward gives the same bits on every call.
"""

import numpy as np
import pytest
import torch

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.coords import INVALID
from detection_3d_tpu_torch.ops.multi_match import (
    conv_rulebook_match, deconv_rulebook_match, multi_match_cuda,
    multi_match_plain)
from detection_3d_tpu_torch.ops.rotated_iou import (
    PARK_QUERIES, PARK_TARGETS, park_invalid, rotated_iou_cuda,
    rotated_iou_plain,
)
from detection_3d_tpu_torch.models.backbone import bev_with_rulebook
from detection_3d_tpu_torch.ops.sparse import (
    SUBM_WINDOW, build_sparse_tensor, downsample_with_rulebooks,
    neighbor_indices, neighbor_match_3x3x3, neighbor_match_columns,
    submanifold_offsets, subm_match_cuda,
)
from detection_3d_tpu_torch.ops.sparse_conv import (
    BackwardBook, RowOrder, backward_book, gather_conv, gather_conv_backward,
    gather_conv_cuda, gather_conv_dfeats, gather_conv_dfeats_cuda,
    gather_conv_dw, gather_conv_dw_cuda, row_masks, rulebook_entries,
    rulebook_row_order, sparse_conv,
)
from torch_iou_cases import adversarial_bev
from torch_match_cases import MATCH_CASES

pytestmark = pytest.mark.cuda

SPATIAL = (64, 48, 32)


@pytest.fixture
def dev():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _table(dev, n, cap, seed, spatial=SPATIAL):
    rng = np.random.RandomState(seed)
    coords = np.stack([rng.randint(0, s, n) for s in spatial]
                      + [np.zeros(n, np.int64)], -1).astype(np.int32)
    coords = torch.from_numpy(coords).to(dev)
    return build_sparse_tensor(coords, torch.zeros((n, 0), device=dev),
                               None, spatial, 1, cap)


@pytest.mark.parametrize("case", ["partial", "dense"])
def test_subm_match_bit_exact(dev, case):
    t = (_table(dev, 1500, 4096, 1) if case == "partial"
         else _table(dev, 7000, 8192, 5, spatial=(16, 24, 24)))
    got, masks = neighbor_match_3x3x3(t)
    want = neighbor_indices(t, submanifold_offsets((3, 3, 3)))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(masks, row_masks(want, t.capacity, t.row_valid))


def _case_table(dev, case):
    coords, spatial, cap, batch = MATCH_CASES[case]()
    coords = torch.from_numpy(coords).to(dev)
    return build_sparse_tensor(coords, torch.zeros((coords.shape[0], 0),
                                                   device=dev),
                               None, spatial, batch, cap)


@pytest.mark.parametrize("window", [None, SUBM_WINDOW, 16, 1, 0])
@pytest.mark.parametrize("case", sorted(MATCH_CASES))
def test_subm_match_columns_bit_exact(dev, case, window):
    """Kernel B's book and row masks against neighbor_indices, row_masks
    and the plain column algorithm: with the wrapper's choice (None), with
    shared-memory windows (windows of 16 or 1 rows send most or all of a
    block's searches to global memory) and with the whole-table search
    (0). One launch a call, the same bits on a second call."""
    t = _case_table(dev, case)
    before = cuda_lib.launches["subm_match"]
    got, masks = subm_match_cuda(t, window)
    again, masks_again = subm_match_cuda(t, window)
    torch.cuda.synchronize()
    assert cuda_lib.launches["subm_match"] == before + 2
    want = neighbor_indices(t, submanifold_offsets((3, 3, 3)))
    assert torch.equal(got, want)
    assert torch.equal(masks, row_masks(want, t.capacity, t.row_valid))
    plain, plain_masks = neighbor_match_columns(t)
    assert torch.equal(got, plain) and torch.equal(masks, plain_masks)
    assert torch.equal(again, got) and torch.equal(masks_again, masks)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,cin,cout", [("subm", 9, 32), ("subm", 32, 64),
                                           ("down", 16, 8)])
def test_gather_conv_matches_plain(dev, dtype, kind, cin, cout):
    t = _table(dev, 3000, 4096, 2)
    if kind == "subm":
        idx, out_t = neighbor_match_3x3x3(t)[0], t
    else:
        out_t, idx, _ = downsample_with_rulebooks(t, (2, 2, 2), (2, 2, 2),
                                                  2048)
    gen = torch.Generator(device=dev).manual_seed(cin)
    feats = torch.randn((t.capacity, cin), generator=gen, device=dev)
    feats = (feats * t.row_valid[:, None]).to(dtype)
    w = (torch.randn((idx.shape[0], cin, cout), generator=gen, device=dev)
         * 0.2).to(dtype)
    valid = out_t.row_valid
    before = cuda_lib.launches["gather_conv"]
    got = sparse_conv(feats, idx, w, valid)
    assert cuda_lib.launches["gather_conv"] == before + 1
    want = gather_conv(feats, idx, w, valid)
    assert got.dtype == dtype
    scale = max(float(want.float().abs().max()), 1.0)
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)
    assert bool((got[~valid] == 0).all())


def test_gather_conv_rejects_mixed_dtypes(dev):
    feats = torch.zeros((16, 8), device=dev)
    idx = torch.zeros((1, 16), dtype=torch.int32, device=dev)
    w = torch.zeros((1, 8, 8), dtype=torch.bfloat16, device=dev)
    valid = torch.ones(16, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        gather_conv_cuda(feats, idx, w, valid)


def _book(dev, kind, seed=2):
    """(idx, V_in, out_valid) of one rulebook kind over a random table."""
    t = _table(dev, 3000, 4096, seed)
    if kind == "subm":
        return neighbor_match_3x3x3(t)[0], t.capacity, t.row_valid
    if kind == "bev":
        bev, rb = bev_with_rulebook(t, t.capacity)
        return rb, t.capacity, bev.row_valid
    coarse, crb, drb = downsample_with_rulebooks(t, (2, 2, 2), (2, 2, 2),
                                                 2048)
    if kind == "down":
        return crb, t.capacity, coarse.row_valid
    return drb, coarse.capacity, t.row_valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,cin,cout", [("subm", 9, 32), ("subm", 32, 32),
                                           ("subm", 64, 64),
                                           ("subm", 128, 128),
                                           ("subm", 256, 256),
                                           ("subm", 80, 24), ("down", 32, 64),
                                           ("up", 128, 128),
                                           ("bev", 128, 128)])
@pytest.mark.parametrize("ordering", ["grouped", "scrambled", "identity",
                                      "none"])
def test_gather_conv_row_order_matches_plain(dev, dtype, kind, cin, cout,
                                             ordering):
    """Kernel A with the rulebook's row order, with rows in a random order
    or in their own order (tiles then mix masks), and with no order given
    (the wrapper builds one), against the plain version without one."""
    idx, v_in, valid = _book(dev, kind)
    gen = torch.Generator(device=dev).manual_seed(cin * 7 + cout)
    feats = torch.randn((v_in, cin), generator=gen, device=dev).to(dtype)
    w = (torch.randn((idx.shape[0], cin, cout), generator=gen, device=dev)
         * (2.0 / (idx.shape[0] * cin)) ** 0.5).to(dtype)
    order = None
    if ordering == "grouped":
        order = rulebook_row_order(idx, v_in, valid)
    elif ordering != "none":
        perm = (torch.randperm(idx.shape[1], generator=gen, device=dev)
                if ordering == "scrambled"
                else torch.arange(idx.shape[1], device=dev))
        order = RowOrder(perm.to(torch.int32),
                         row_masks(idx, v_in, valid)[perm])
    got = gather_conv_cuda(feats, idx, w, valid, order)
    want = gather_conv(feats, idx, w, valid)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    _close(got, want, dtype)
    assert bool((got[~valid] == 0).all())


def _bits_equal(got, want):
    same = got.view(torch.int32) == want.view(torch.int32)
    return bool((same | (torch.isnan(got) & torch.isnan(want))).all())


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2, 3])
@pytest.mark.parametrize("same_box_fix", [False, True])
def test_rotated_iou_adversarial_bit_exact(dev, criterion, same_box_fix):
    b = torch.from_numpy(adversarial_bev()).to(dev)
    got = rotated_iou_cuda(b, b, criterion, same_box_fix)
    want = rotated_iou_plain(b, b, criterion, same_box_fix)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


def test_rotated_iou_spread_layout_bit_exact(dev):
    """Many targets against a wide, ordered anchor grid: most blocks cull
    whole targets, the rest mix culled and computed pairs."""
    rng = np.random.RandomState(11)
    xs, ys = np.meshgrid(np.arange(0, 40, 0.25), np.arange(0, 40, 0.5))
    grid = np.c_[xs.ravel(), ys.ravel(),
                 np.full((xs.size, 2), [0.4, 1.5]),
                 np.where(np.arange(xs.size) % 2, np.pi / 2, 0.0)]
    gt = np.c_[rng.uniform(0, 40, (150, 2)), rng.uniform(0.1, 6, (150, 2)),
               rng.uniform(-1.6, 1.6, (150, 1))]
    gt = np.r_[gt, np.tile([[0, 0, 0.1, 0.1, 0]], (50, 1))]
    g = torch.from_numpy(gt.astype(np.float32)).to(dev)
    a = torch.from_numpy(grid.astype(np.float32)).to(dev)
    for criterion in (-1, 2):
        got = rotated_iou_cuda(g, a, criterion, True)
        want = rotated_iou_plain(g, a, criterion, True)
        torch.cuda.synchronize()
        assert _bits_equal(got, want)


def test_rotated_iou_parked_rows_bit_exact(dev):
    """Targets and anchors with pad rows, as rpn_targets hands them over:
    parked far away (culled), or left at the maps' pad coordinate with
    collapsed edges (never culled)."""
    rng = np.random.RandomState(12)
    gt = np.c_[rng.uniform(0, 40, (100, 3)), rng.uniform(0.1, 6, (100, 3)),
               rng.uniform(-1.6, 1.6, (100, 1))].astype(np.float32)
    anc = np.c_[rng.uniform(0, 40, (3000, 3)),
                np.tile([0.4, 1.5, 3.0], (3000, 1)),
                rng.choice([0.0, np.pi / 2], (3000, 1))].astype(np.float32)
    anc[2500:, :3] = 2 ** 31 * 32 / 50          # pad rows' anchors
    g, a = torch.from_numpy(gt).to(dev), torch.from_numpy(anc).to(dev)
    gv = torch.arange(100, device=dev) < 80
    av = torch.arange(3000, device=dev) < 2500
    bev = [0, 1, 3, 4, 6]
    for t, q in ((g, a), (park_invalid(g, gv, PARK_TARGETS),
                          park_invalid(a, av, PARK_QUERIES))):
        t, q = t[:, bev].contiguous(), q[:, bev].contiguous()
        for criterion in (-1, 2):
            got = rotated_iou_cuda(t, q, criterion, True)
            want = rotated_iou_plain(t, q, criterion, True)
            torch.cuda.synchronize()
            assert _bits_equal(got, want)


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotated_iou_matches_plain(dev, criterion):
    rng = np.random.RandomState(7)
    boxes = np.c_[rng.uniform(-3, 3, (300, 2)),
                  rng.uniform(0.1, 2.5, (300, 2)),
                  rng.uniform(-1.6, 1.6, (300, 1))].astype(np.float32)
    special = np.array([[0, 0, 2, 1, 0], [0, 0, 2, 1, 0], [2, 0, 2, 1, 0],
                        [2, 1, 2, 1, 0], [0, 0, 1, 0.5, 0],
                        [0, 0, 4, 0.095, 0.3], [0, 0, 1, 2, 0]], np.float32)
    b = torch.from_numpy(np.r_[boxes, special]).to(dev)
    got = rotated_iou_cuda(b, b, criterion)
    want = rotated_iou_plain(b, b, criterion)
    torch.cuda.synchronize()
    assert _bits_equal(got, want)


def _close(got, want, dtype):
    scale = max(float(want.float().abs().max()), 1.0)
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,cin,cout", [("subm", 9, 32), ("subm", 32, 64),
                                           ("subm", 80, 24),
                                           ("subm", 128, 128),
                                           ("subm", 256, 256),
                                           ("subm_big", 32, 32),
                                           ("down", 16, 8), ("up", 8, 16),
                                           ("bev", 128, 128)])
def test_gather_conv_backward_matches_plain(dev, dtype, kind, cin, cout):
    """dFeats (kernel A on the transposed book) and dW (the entry-list
    kernel) against gather_conv_backward and their own plain versions,
    one launch each, the same bits on a second call."""
    if kind == "subm_big":   # many work items per offset
        t = _table(dev, 40000, 65536, 3, spatial=(128, 128, 64))
        idx, v_in, valid = neighbor_match_3x3x3(t)[0], t.capacity, t.row_valid
    else:
        idx, v_in, valid = _book(dev, kind, seed=3)
    gen = torch.Generator(device=dev).manual_seed(cin + cout)
    feats = torch.randn((v_in, cin), generator=gen, device=dev).to(dtype)
    w = (torch.randn((idx.shape[0], cin, cout), generator=gen, device=dev)
         * 0.2).to(dtype)
    g = torch.randn((idx.shape[1], cout), generator=gen,
                    device=dev).to(dtype)
    book = backward_book(idx, v_in, valid)
    want_f, want_w = gather_conv_backward(feats, idx, w, valid, g)
    before = dict(cuda_lib.launches)
    got_f = gather_conv_dfeats_cuda(g, w, book)
    got_w = gather_conv_dw_cuda(feats, g, book)
    torch.cuda.synchronize()
    assert cuda_lib.launches["gather_conv_dfeats"] == \
        before["gather_conv_dfeats"] + 1
    assert cuda_lib.launches["gather_conv_dw"] == before["gather_conv_dw"] + 1
    assert cuda_lib.launches["gather_conv"] == before["gather_conv"]
    assert got_f.dtype == got_w.dtype == dtype
    assert got_f.shape == want_f.shape and got_w.shape == want_w.shape
    _close(got_f, want_f, dtype)
    _close(got_w, want_w, dtype)
    _close(got_f, gather_conv_dfeats(g, w, book), dtype)
    _close(got_w, gather_conv_dw(feats, g, book), dtype)
    assert torch.equal(_bits(gather_conv_dfeats_cuda(g, w, book)),
                       _bits(got_f))
    assert torch.equal(_bits(gather_conv_dw_cuda(feats, g, book)),
                       _bits(got_w))


def _pyramid_book(idx, v_in, valid, order, kind):
    """The BackwardBook as build_pyramid makes it for a submanifold book
    (the book itself, read with its offsets reversed); the scatter for
    the other kinds."""
    if kind == "subm":
        return BackwardBook(idx, order, *rulebook_entries(idx, v_in, valid),
                            reversed=True)
    return backward_book(idx, v_in, valid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 128)])
def test_backward_on_a_reversed_submanifold_book(dev, dtype, cin, cout):
    """dFeats on a submanifold book read with its offsets reversed, as the
    training pyramid hands it over, and dW on its entry lists, also with
    each offset's entries in reverse order (a deconv book's lists come
    in its conv book's order)."""
    idx, v_in, valid = _book(dev, "subm", seed=5)
    gen = torch.Generator(device=dev).manual_seed(cin)
    feats = torch.randn((v_in, cin), generator=gen, device=dev).to(dtype)
    w = (torch.randn((27, cin, cout), generator=gen, device=dev)
         * 0.2).to(dtype)
    g = torch.randn((v_in, cout), generator=gen, device=dev).to(dtype)
    book = _pyramid_book(idx, v_in, valid,
                         rulebook_row_order(idx, v_in, valid), "subm")
    want_f, want_w = gather_conv_backward(feats, idx, w, valid, g)
    _close(gather_conv_dfeats_cuda(g, w, book), want_f, dtype)
    _close(gather_conv_dw_cuda(feats, g, book), want_w, dtype)
    # the list read backwards: offset K - 1 - k's pairs, last first, as
    # offset k
    backwards = book._replace(entries=book.entries.flip(0).contiguous(),
                              starts=book.starts[-1] - book.starts.flip(0))
    _close(gather_conv_dw_cuda(feats, g, backwards).flip(0), want_w, dtype)


@pytest.mark.parametrize("kind", ["subm", "down", "up", "bev"])
def test_gather_conv_function_on_a_pyramid_book(dev, kind):
    """GatherConv with the rulebook's order and backward book: one launch
    each of A, dFeats and dW, and the gradients of the plain backward."""
    idx, v_in, valid = _book(dev, kind, seed=4)
    gen = torch.Generator(device=dev).manual_seed(0)
    base = torch.randn((v_in, 16), generator=gen, device=dev)
    w0 = torch.randn((idx.shape[0], 16, 16), generator=gen, device=dev) * 0.1
    feats, w = base.clone().requires_grad_(), w0.clone().requires_grad_()
    order = rulebook_row_order(idx, v_in, valid)
    book = _pyramid_book(idx, v_in, valid, order, kind)
    cuda_lib.reset_launches()
    out = sparse_conv(feats, idx, w, valid, order, book)
    g = torch.randn(out.shape, generator=gen, device=dev)
    out.backward(g)
    torch.cuda.synchronize()
    assert cuda_lib.launches["gather_conv"] == 1
    assert cuda_lib.launches["gather_conv_dfeats"] == 1
    assert cuda_lib.launches["gather_conv_dw"] == 1
    want_f, want_w = gather_conv_backward(base, idx, w0, valid, g)
    _close(feats.grad, want_f, torch.float32)
    _close(w.grad, want_w, torch.float32)


def test_gather_conv_function_launches_both_backward_kernels(dev):
    """No book given: the backward builds one and launches both kernels."""
    t = _table(dev, 2000, 4096, 4)
    idx, _ = neighbor_match_3x3x3(t)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((t.capacity, 16), generator=gen, device=dev)
    feats = (feats * t.row_valid[:, None]).requires_grad_()
    w = (torch.randn((27, 16, 16), generator=gen, device=dev)
         * 0.1).requires_grad_()
    cuda_lib.reset_launches()
    sparse_conv(feats, idx, w, t.row_valid).square().sum().backward()
    torch.cuda.synchronize()
    assert cuda_lib.launches["gather_conv"] == 1
    assert cuda_lib.launches["gather_conv_dfeats"] == 1
    assert cuda_lib.launches["gather_conv_dw"] == 1
    assert bool(torch.isfinite(feats.grad).all())
    assert bool(torch.isfinite(w.grad).all())


@pytest.mark.parametrize("seed", [1, 6])
def test_multi_match_bit_exact(dev, seed):
    t = _table(dev, 3000, 4096, seed)
    coarse, crb, drb = downsample_with_rulebooks(t, (2, 2, 2), (2, 2, 2),
                                                 2048)
    before = cuda_lib.launches["multi_match"]
    got_c = conv_rulebook_match(coarse, t, (2, 2, 2), (2, 2, 2))
    got_d = deconv_rulebook_match(t, coarse, (2, 2, 2), (2, 2, 2))
    torch.cuda.synchronize()
    assert cuda_lib.launches["multi_match"] == before + 2
    assert torch.equal(got_c, crb) and torch.equal(got_d, drb)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randint(0, t.capacity, (5000,), generator=gen, device=dev)
    q = t.keys[rows] + torch.randint(0, 2, (5000,), generator=gen,
                                     device=dev)
    assert torch.equal(multi_match_cuda(t.keys, q),
                       multi_match_plain(t.keys, q))


def _queries(dev, kind, keys, gen):
    """Composite queries against a table's keys: hits (real keys), misses
    (a key + 1) and invalid ones (high half INVALID), in key order or
    shuffled; "invalid_blocks" leaves whole 256-query blocks invalid."""
    v = keys.shape[0]
    rows = torch.randint(0, v, (5000,), generator=gen, device=dev)
    q = keys[rows] + torch.randint(0, 2, (5000,), generator=gen, device=dev)
    invalid = (INVALID << 32) | 5
    q[::17] = invalid
    if kind == "sorted":
        return torch.sort(q).values
    if kind == "invalid_blocks":
        q = torch.sort(q).values
        q[256:1024] = invalid
        q[-300:] = invalid
        return q
    return q[torch.randperm(q.numel(), generator=gen, device=dev)]


@pytest.mark.parametrize("kind", ["sorted", "unsorted", "invalid_blocks",
                                  "small_table"])
def test_multi_match_query_orders_bit_exact(dev, kind):
    """Kernel D against multi_match_plain on sorted and unsorted queries,
    on blocks with no valid query and on a table of fewer rows than a
    block. The same bits on a second call."""
    t = (_table(dev, 150, 200, 9, spatial=(8, 8, 8))
         if kind == "small_table" else _table(dev, 3000, 4096, 8))
    gen = torch.Generator(device=dev).manual_seed(3)
    q = _queries(dev, "unsorted" if kind == "small_table" else kind, t.keys,
                 gen)
    got = multi_match_cuda(t.keys, q)
    want = multi_match_plain(t.keys, q)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((got < t.capacity).any()) and bool((got == t.capacity).any())
    assert torch.equal(multi_match_cuda(t.keys, q), got)


def test_evaluate_detections_card_matches_cpu(dev):
    """The evaluator with kernel C on the card against the plain IoU on
    the CPU: 300 gts a class over three classes and two buildings, the
    predictions jittered gts and false positives (none within 0.02 of the
    0.2 threshold by the CPU's IoU). The match arrays, precision, recall
    and scores are equal; AP, AIoU and the rates within 1e-6; kernel C
    runs once per (building, class) pair. One pair's IoU within 2e-4:
    the card's sin/cos and the CPU's may differ in the last bit, and a
    float32 corner 40 m from the origin is only good to ~4e-6 m, which
    moves a thin box's IoU by ~1e-4 (1.06e-4 measured on an H100; the
    CPU tests allow 1e-4 at 20 m, tests/test_torch_evaluation.py).
    Every comparison is made before any is asserted, so a failure
    reports them all."""
    from detection_3d_tpu_torch.evaluation.detection_eval import (
        evaluate_detections)
    from detection_3d_tpu_torch.ops.rotated_iou import boxes_iou_3d
    rng = np.random.RandomState(11)
    aug = {"target_Y": 0.2, "anchor_Y": 0.2, "target_Z": 0.2,
           "anchor_Z": 0.2}

    def boxes(n):
        return np.c_[rng.uniform(0, 40, (n, 2)), rng.uniform(0, 1, n),
                     rng.uniform(0.1, 3, (n, 2)), rng.uniform(0.5, 3, n),
                     rng.uniform(-1.57, 1.57, n)].astype(np.float32)

    preds, gts = [], []
    for _ in range(2):
        gb, gl, pb, pl = [], [], [], []
        for label in (1, 2, 3):
            g = boxes(300)
            p = g.copy()
            p[:, :3] += rng.normal(0, 0.1, (300, 3))
            p[:, 6] += rng.normal(0, 0.1, 300)
            p = np.r_[p, boxes(100)].astype(np.float32)
            iou = boxes_iou_3d(torch.from_numpy(g), torch.from_numpy(p),
                               aug_thickness=aug).numpy()
            p = p[~(np.abs(iou - 0.2) < 0.02).any(0)]
            gb += [g]
            gl += [np.full(300, label)]
            pb += [p]
            pl += [np.full(len(p), label)]
        gts.append({"boxes": np.concatenate(gb), "labels": np.concatenate(gl)})
        pb = np.concatenate(pb)
        preds.append({"boxes": pb, "labels": np.concatenate(pl),
                      "scores": rng.uniform(0, 1, len(pb))})
    kw = dict(num_classes=4, iou_thresh=0.2, eval_aug_thickness=aug)
    want = evaluate_detections(preds, gts, device="cpu", **kw)
    cuda_lib.reset_launches()
    got = evaluate_detections(preds, gts, device=dev, **kw)
    launches = cuda_lib.launches["rotated_iou"]
    assert sorted(got.curves) == sorted(want.curves) == [1, 2, 3]
    bad = [] if launches == 6 else [f"{launches} launches of kernel C"]
    for label, c in want.curves.items():
        for key in ("match", "prec", "rec", "score"):
            if not np.array_equal(got.curves[label][key], c[key]):
                bad.append(f"class {label}: {key} differs")
        d = np.abs(got.curves[label]["iou"] - c["iou"]).max()
        if d > 2e-4:
            bad.append(f"class {label}: a pair's IoU differs by {d}")
    for field in ("ap", "aiou", "missed_rate", "multi_rate"):
        d = np.abs(getattr(got, field) - getattr(want, field)).max()
        if not d <= 1e-6:
            bad.append(f"{field} differs by {d}")
    if not np.array_equal(got.n_gt, want.n_gt):
        bad.append("n_gt differs")
    assert not bad, bad


def _tiny_served(seed):
    """chip_smoke.py's tiny config (the parity tests' one) and a small
    synthetic building."""
    from chip_smoke import tiny_config
    from detection_3d_tpu_torch.data.synthetic import synthetic_building
    cfg = tiny_config()
    return cfg, synthetic_building(seed=seed, num_points=6000, room=6.0,
                                   classes=cfg.classes, voxel_scale=20)


def test_host_pyramid_on_card_matches_build_pyramid(dev):
    """The C++ packer's pyramid, unpacked on the card, against
    build_pyramid on the card (kernel B's books and masks) for the same
    pack's table: every table, book and row order bit equal."""
    from detection_3d_tpu_torch.data.native_packer import pack_pyramid_native
    from detection_3d_tpu_torch.data.packing import to_device, unpack_table
    from detection_3d_tpu_torch.data.pyramid_packing import unpack_pyramid
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    cfg, scene = _tiny_served(3)
    packed = to_device(pack_pyramid_native(cfg, scene), dev)
    got = unpack_pyramid(cfg, packed)
    before = cuda_lib.launches["subm_match"]
    want = build_pyramid(unpack_table(cfg, packed), cfg)
    torch.cuda.synchronize()
    assert cuda_lib.launches["subm_match"] == before + cfg.sparse3d.num_scales
    for a, b in zip(got["tables"], want["tables"], strict=True):
        for f in ("coords", "hi", "lo", "keys", "num"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    for key in ("subm_idx", "down_rb", "up_rb"):
        for a, b in zip(got[key], want[key], strict=True):
            assert torch.equal(a, b), key
    for key in ("subm_order", "down_order", "up_order"):
        for a, b in zip(got[key], want[key], strict=True):
            assert torch.equal(a.perm, b.perm) and torch.equal(a.masks,
                                                               b.masks), key
    for slot, (t, rb) in want["bev"].items():
        gt, grb = got["bev"][slot]
        assert torch.equal(gt.coords, t.coords) and torch.equal(grb, rb)
        assert torch.equal(got["bev_order"][slot].perm,
                           want["bev_order"][slot].perm)
        assert torch.equal(got["bev_order"][slot].masks,
                           want["bev_order"][slot].masks)


@pytest.mark.parametrize("batch_size", [1, 2])
@pytest.mark.parametrize("pack_mode", ["pyramid", "table"])
def test_pipelined_on_card_matches_sequential(dev, pack_mode, batch_size):
    """run_inference(pipelined=True) on the card, whose pack workers copy
    on their own streams, against the sequential packed predict on the
    same C++ packs, within 1e-6; kernel B runs in table mode only."""
    from detection_3d_tpu_torch.data.native_packer import (
        pack_pyramid_native, pack_table_native)
    from detection_3d_tpu_torch.engine.inference import (
        make_predict_fn, run_inference)
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    cfg, _ = _tiny_served(0)
    scenes = [_tiny_served(s)[1] for s in range(3)]
    model = SparseRCNN(cfg, seed=0)
    pack = {"pyramid": pack_pyramid_native, "table": pack_table_native}
    predict = make_predict_fn(cfg, model, device=dev, packed=pack_mode)
    want = [predict(pack[pack_mode](cfg, s)) for s in scenes]
    cuda_lib.reset_launches()
    preds, _, _ = run_inference(cfg, model, scenes, device=dev,
                                pipelined=True, pack_mode=pack_mode,
                                batch_size=batch_size)
    launches = dict(cuda_lib.launches)
    assert launches["gather_conv"] > 0 and launches["rotated_iou"] > 0
    assert (launches["subm_match"] > 0) == (pack_mode == "table")
    for p, (out, true_num) in zip(preds, want, strict=True):
        a = out.cpu().numpy()
        v = a[:, 9] > 0.5
        assert p["true_num"] == int(true_num)
        np.testing.assert_allclose(p["boxes"], a[v, :7], atol=1e-6, rtol=0)
        np.testing.assert_allclose(p["scores"], a[v, 7], atol=1e-6, rtol=0)


def test_host_training_pyramid_on_card_matches_build_pyramid(dev):
    """A pack with its backward books, unpacked on the card, against
    build_pyramid(..., backward=True) on the card for the same pack's
    table: every BackwardBook field bit equal, for every book kind."""
    from detection_3d_tpu_torch.data.native_packer import pack_pyramid_native
    from detection_3d_tpu_torch.data.packing import to_device, unpack_table
    from detection_3d_tpu_torch.data.pyramid_packing import unpack_pyramid
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    cfg, scene = _tiny_served(4)
    packed = to_device(pack_pyramid_native(cfg, scene, backward=True), dev)
    got = unpack_pyramid(cfg, packed, backward=True)
    want = build_pyramid(unpack_table(cfg, packed), cfg, backward=True)
    pairs = [(a, b) for key in ("subm_bwd", "down_bwd", "up_bwd")
             for a, b in zip(got[key], want[key], strict=True)]
    pairs += [(got["bev_bwd"][s], want["bev_bwd"][s]) for s in want["bev"]]
    assert len(pairs) == 3 * cfg.sparse3d.num_scales - 2 + len(want["bev"])
    for a, b in pairs:
        for f in ("t_idx", "entries", "starts"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and torch.equal(x, y), f
        assert torch.equal(a.t_order.perm, b.t_order.perm)
        assert torch.equal(a.t_order.masks, b.t_order.masks)
        assert a.reversed == b.reversed


def test_packed_training_step_launches(dev, tmp_path):
    """Trainer.step(packed="pyramid") on the card: finite, applied, A,
    dFeats, dW and C launched and B not; the raw step launches B."""
    from detection_3d_tpu_torch.data.native_packer import pack_pyramid_native
    from detection_3d_tpu_torch.engine.trainer import Trainer, pad_scene
    cfg, scene = _tiny_served(5)
    trainer = Trainer(cfg, output_dir=str(tmp_path), device=dev)
    state = trainer.init_state(seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for packed, batch in (("pyramid", pack_pyramid_native(cfg, scene,
                                                          backward=True)),
                          (False, pad_scene(cfg, scene))):
        cuda_lib.reset_launches()
        total, _, ok, true_num = trainer.step(state, batch, gen,
                                              packed=packed)
        launches = dict(cuda_lib.launches)
        assert np.isfinite(total) and ok and true_num > 0
        for name in ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
                     "rotated_iou"):
            assert launches[name] > 0, (packed, name)
        assert (launches["subm_match"] > 0) == (packed is False), launches
    assert state.solver.count == 2


def test_grouped_forward_card_matches_cpu(dev):
    """The 3G6c model (chip_smoke.tiny_3g6c_config: 3 groups) on the card
    against the CPU with the same weights: the detections the same set
    (boxes and scores within 1e-4) with original labels in 1..5, and one
    training step's 12 losses within 1e-4 and gradients within 1e-3 of
    each one's largest entry + 1e-5, kernels A, dFeats, dW, B and C
    launched."""
    from chip_smoke import (
        tiny_3g6c_config, tiny_predict_card_vs_cpu, tiny_scene,
        tiny_train_card_vs_cpu)
    cfg = tiny_3g6c_config()
    scene = tiny_scene(cfg)
    cuda_lib.reset_launches()
    rows = tiny_predict_card_vs_cpu(cfg, scene, card=dev)
    assert rows[:, 8].min() >= 1 and rows[:, 8].max() <= 5
    losses = tiny_train_card_vs_cpu(cfg, scene, card=dev)
    assert len(losses) == 12
    for name in ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
                 "subm_match", "rotated_iou"):
        assert cuda_lib.launches[name] > 0, name


def test_rpn_only_forward_card_matches_cpu(dev):
    """An rpn_only model (chip_smoke.tiny_config) on the card against the
    CPU: its proposals the same set within 1e-4, every label 1."""
    from chip_smoke import tiny_config, tiny_predict_card_vs_cpu, tiny_scene
    cfg = tiny_config().replace(rpn_only=True)
    rows = tiny_predict_card_vs_cpu(cfg, tiny_scene(cfg), card=dev)
    assert np.all(rows[:, 8] == 1)


@pytest.mark.parametrize("shards", [2, 3])
def test_kernel_d_and_backward_on_shard_pyramids(dev, tmp_path, shards):
    """Spatial shards (gloo ranks sharing the card) build their training
    pyramids over extended tables: every strided and deconv book kernel D
    gives is bit equal to its plain version on the same tables, and
    dFeats and dW on every submanifold and deconv book's BackwardBook
    (halo rows as inputs, own rows as outputs) are within 1e-4 of the
    plain versions' largest value; B and D launched on every rank."""
    from chip_smoke import (
        SMALL_HALO_CAPS, SMALL_SHARD_CAPS, tiny_scene, tiny_spatial_config)
    from detection_3d_tpu_torch.engine.trainer import pad_scene
    from detection_3d_tpu_torch.parallel.checks import shard_kernels_job
    from detection_3d_tpu_torch.parallel.mesh import launch
    cfg, halo_caps = tiny_spatial_config(), SMALL_HALO_CAPS
    if shards == 3:
        # X = 192 is divisible by 3 shards x 8; the third slab is empty,
        # and at scale 3 the x = 122 wall lies on a slab edge: its
        # column takes the exact bound Y_3 * Z_3 = 128
        import dataclasses
        cfg = cfg.replace(sparse3d=dataclasses.replace(
            cfg.sparse3d, voxel_full_scale=(192, 128, 64)))
        halo_caps = halo_caps[:3] + (128,)
    cuda_lib.build()            # once, before the ranks start
    batch = pad_scene(cfg, tiny_scene(cfg))
    res = launch(shard_kernels_job, shards, "gloo", str(tmp_path / "init"),
                 args=(cfg, batch, SMALL_SHARD_CAPS, halo_caps),
                 cpu_threads=0)
    n = cfg.sparse3d.num_scales
    for r in res:
        assert all(r["down_equal"]) and all(r["up_equal"])
        assert r["errs"]["dfeats"] < 1e-4 and r["errs"]["dw"] < 1e-4, r
        assert r["launches"]["multi_match"] == 2 * (n - 1)
        assert r["launches"]["subm_match"] == n
        assert not bool(r["overflow"])
    assert sum(sum(r["halo_rows"]) for r in res) > 0


def test_small_zoo_card_matches_cpu(dev):
    """plan_levels, a residual SparseUNet and a SparseVGG (C, MP, C3/2)
    on the card against the CPU with the same weights (chip_smoke.
    small_zoo_card_vs_cpu: books bit equal, f32 outputs within 1e-4 of
    the largest, gradients within 1e-3 of each one's largest + 1e-5),
    kernels A, dFeats, dW and B launched."""
    from chip_smoke import small_zoo_card_vs_cpu
    cuda_lib.reset_launches()
    report = small_zoo_card_vs_cpu(card=dev)
    assert set(report) == {"unet", "vgg"}
    for name in ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
                 "subm_match"):
        assert cuda_lib.launches[name] > 0, name


def test_searched_books_through_kernel_d(dev):
    """ops/sparse.conv_rulebook and ops/sparse_conv.deconv_rulebook on
    the card: kernel D, once each, bit equal to the scatter books."""
    from detection_3d_tpu_torch.ops.sparse import conv_rulebook
    from detection_3d_tpu_torch.ops.sparse_conv import deconv_rulebook
    t0 = _table(dev, 3000, 4096, 9)
    t1, crb, drb = downsample_with_rulebooks(t0, (2, 2, 2), (2, 2, 2), 2048)
    cuda_lib.reset_launches()
    conv = conv_rulebook(t1, t0, (2, 2, 2), (2, 2, 2))
    dec = deconv_rulebook(t0, t1, (2, 2, 2), (2, 2, 2))
    torch.cuda.synchronize()
    assert cuda_lib.launches["multi_match"] == 2
    assert torch.equal(conv, crb) and torch.equal(dec, drb)


def test_rotate_nms_3d_card_matches_cpu(dev):
    """rotate_nms_3d on the card (kernel C, once) keeps the boxes its
    plain version keeps on the CPU."""
    from chip_smoke import _nms_boxes_np
    from detection_3d_tpu_torch.ops.nms import rotate_nms_3d
    rng = np.random.RandomState(2)
    host = (torch.from_numpy(_nms_boxes_np(400, 2)),
            torch.from_numpy(rng.rand(400).astype(np.float32)),
            torch.from_numpy(rng.rand(400) > 0.1))
    cuda_lib.reset_launches()
    keep, count = rotate_nms_3d(*(x.to(dev) for x in host), 0.3, 400)
    torch.cuda.synchronize()
    assert cuda_lib.launches["rotated_iou"] == 1
    want, want_count = rotate_nms_3d(*host, 0.3, 400)
    assert int(count) == int(want_count) > 0
    assert torch.equal(keep.cpu(), want)


def test_bench_parity_on_a_small_building(dev, capsys):
    """The bench twin's --parity checks (tools/bench.parity) on a small
    building: B bit exact against neighbor_indices, A against the plain
    gather_conv in bf16, the searched books through D bit equal to the
    scatter books, at three scales; each kernel launched once a scale (D
    twice)."""
    from detection_3d_tpu_torch.tools import bench
    cfg, scene = _tiny_served(0)
    cuda_lib.reset_launches()
    assert bench.parity(cfg, scene, dev) == []
    torch.cuda.synchronize()
    assert cuda_lib.launches["subm_match"] == 3
    assert cuda_lib.launches["gather_conv"] == 3
    assert cuda_lib.launches["multi_match"] == 6
    assert capsys.readouterr().out.count(": OK") == 12


def test_device_activity_counts_overlapping_streams_once(dev):
    """A pinned host-to-device copy on a side stream beside matmuls on the
    serving stream: utils/profiling.device_activity's busy time (the
    union over the streams) lies below the sum of the activities, at or
    above the longest one, within the span, on two streams."""
    from detection_3d_tpu_torch.utils.profiling import device_activity
    host = torch.empty((64 << 20,), dtype=torch.float32).pin_memory()
    a = torch.randn((4096, 4096), device=dev)
    side = torch.cuda.Stream(dev)

    def run():
        with torch.cuda.stream(side):
            on_card = host.to(dev, non_blocking=True)
        for _ in range(8):
            a @ a
        side.synchronize()
        return on_card

    run()
    act = device_activity(run, dev)
    longest = max(act["by_name_ms"].values())
    assert act["streams"] >= 2 and act["memcpy_ms"] > 0
    assert act["busy_ms"] < act["sum_ms"]
    assert longest <= act["busy_ms"] <= act["span_ms"]
    assert 0.0 <= act["idle_share"] < 1.0
    assert act["device"] == torch.cuda.get_device_name(dev)


def test_device_activity_names_the_port_kernels(dev):
    """Kernel A's launches under the profiler show under its counter's
    symbol and its short name."""
    from detection_3d_tpu_torch.utils.profiling import device_activity
    t = _table(dev, 3000, 4096, 9)
    idx, _ = neighbor_match_3x3x3(t)
    feats = torch.randn((t.capacity, 32), device=dev)
    w = torch.randn((27, 32, 32), device=dev)
    act = device_activity(
        lambda: gather_conv_cuda(feats, idx, w, t.row_valid), dev)
    assert act["port_kernels_ms"]["gather_conv"] > 0
    assert "A" in [label for label, _ in act["top_ms"]]
