"""The port's CUDA kernels against their plain PyTorch versions, on
the card. Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is false. The file imports nothing of JAX,
so it runs on a machine without it (tests/conftest.py imports JAX, so
skip it there):

    python -m pytest --noconftest -p no:randomly -q tests/test_torch_kernels_cuda.py

Tolerances: kernels B and D are bit exact; kernel A and its two
backward kernels within 1e-4 of the largest output in f32 (sum order;
the backward adds with atomics, in an order that changes from run to
run) and 1e-2 in bf16 (one bf16 rounding of the f32 sum); kernel C
within 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.multi_match import (
    conv_rulebook_match, deconv_rulebook_match, multi_match_cuda,
    multi_match_plain)
from detection_3d_tpu_torch.ops.rotated_iou import (
    rotated_iou_cuda, rotated_iou_plain,
)
from detection_3d_tpu_torch.ops.sparse import (
    build_sparse_tensor, downsample_with_rulebooks, neighbor_indices,
    neighbor_match_3x3x3, submanifold_offsets,
)
from detection_3d_tpu_torch.ops.sparse_conv import (
    gather_conv, gather_conv_backward, gather_conv_cuda,
    gather_conv_dfeats_cuda, gather_conv_dw_cuda, sparse_conv,
)

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
    got = neighbor_match_3x3x3(t)
    want = neighbor_indices(t, submanifold_offsets((3, 3, 3)))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,cin,cout", [("subm", 9, 32), ("subm", 32, 64),
                                           ("down", 16, 8)])
def test_gather_conv_matches_plain(dev, dtype, kind, cin, cout):
    t = _table(dev, 3000, 4096, 2)
    if kind == "subm":
        idx, out_t = neighbor_match_3x3x3(t), t
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
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


def _close(got, want, dtype):
    scale = max(float(want.float().abs().max()), 1.0)
    tol = (1e-4 if dtype == torch.float32 else 1e-2) * scale
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,cin,cout", [("subm", 9, 32), ("subm", 32, 64),
                                           ("subm", 80, 24),
                                           ("down", 16, 8), ("up", 8, 16)])
def test_gather_conv_backward_matches_plain(dev, dtype, kind, cin, cout):
    t = _table(dev, 3000, 4096, 3)
    if kind == "subm":
        idx, t_in, t_out = neighbor_match_3x3x3(t), t, t
    else:
        coarse, crb, drb = downsample_with_rulebooks(t, (2, 2, 2),
                                                     (2, 2, 2), 2048)
        idx, t_in, t_out = ((crb, t, coarse) if kind == "down"
                            else (drb, coarse, t))
    gen = torch.Generator(device=dev).manual_seed(cin + cout)
    feats = (torch.randn((t_in.capacity, cin), generator=gen, device=dev)
             * t_in.row_valid[:, None]).to(dtype)
    w = (torch.randn((idx.shape[0], cin, cout), generator=gen, device=dev)
         * 0.2).to(dtype)
    g = torch.randn((t_out.capacity, cout), generator=gen,
                    device=dev).to(dtype)
    valid = t_out.row_valid
    want_f, want_w = gather_conv_backward(feats, idx, w, valid, g)
    before = dict(cuda_lib.launches)
    got_f = gather_conv_dfeats_cuda(feats, idx, w, valid, g)
    got_w = gather_conv_dw_cuda(feats, idx, w, valid, g)
    torch.cuda.synchronize()
    assert cuda_lib.launches["gather_conv_dfeats"] == \
        before["gather_conv_dfeats"] + 1
    assert cuda_lib.launches["gather_conv_dw"] == before["gather_conv_dw"] + 1
    assert got_f.dtype == got_w.dtype == dtype
    _close(got_f, want_f, dtype)
    _close(got_w, want_w, dtype)


def test_gather_conv_function_launches_both_backward_kernels(dev):
    t = _table(dev, 2000, 4096, 4)
    idx = neighbor_match_3x3x3(t)
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
