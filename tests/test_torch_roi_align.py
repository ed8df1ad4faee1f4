"""The ROI pooler's CPU path (ops/roi_align.py).

CPU tensors take the plain version, :func:`roi_align_plain`, and launch
nothing; its gradient (autograd through ``_CornerGather``, missing
corners dropped) is held against central differences in float64. The
kernels' wrappers and :class:`RotatedROIAlign` take CUDA tensors only;
tests/test_torch_roi_align_cuda.py holds them against the plain version
on the card. The pooler's parity with JAX stays in
test_torch_backbone.py::test_pool_rois_matches_jax and
test_torch_batched_forward.py::test_roi_align_reads_a_zero_pad_row_as_jax.
"""

import pytest
import torch

from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.roi_align import (
    RotatedROIAlign, roi_align_bwd_cuda, roi_align_cuda, roi_align_pairs_cuda,
    roi_align_plain, roi_align_rotated_sparse)
from torch_roi_cases import roi_boxes, roi_table

OUT = (2, 3, 2)

# (buildings, level caps, sampling ratio): one building on one level,
# two levels, a stacked unit of 2 on two levels, a ratio of 1 and of 3
CASES = [(1, (150,), 2), (1, (200, 100), 2), (2, (200, 100), 2),
         (1, (200, 100), 1), (2, (120, 60), 3)]


def _case(nb, caps, dtype, seed=0):
    table = roi_table(nb, caps, c=3, seed=seed, dtype=dtype)
    rois, valid, level = roi_boxes(nb, 6, len(caps), seed=seed)
    return table, rois, valid, level


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("nb,caps,sr", CASES)
def test_cpu_tensors_take_the_plain_version(nb, caps, sr, dtype):
    """roi_align_rotated_sparse on CPU tensors is the plain version, its
    bits and its gradient's, and launches nothing; invalid rois zero."""
    table, rois, valid, level = _case(nb, caps, dtype, seed=3)
    before = dict(cuda_lib.launches)
    got = roi_align_rotated_sparse(table, rois, valid, OUT, sr, level)
    assert cuda_lib.launches == before
    want = roi_align_plain(table, rois, valid, OUT, sr, level)
    assert got.dtype == dtype and got.shape == rois.shape[:-1] + OUT + (3,)
    assert torch.equal(got, want)
    assert not got[~valid].any()
    assert got.abs().max() > 0.1            # rois really meet voxels
    grads = []
    for fn in (roi_align_rotated_sparse, roi_align_plain):
        f = table.feats.clone().requires_grad_()
        out = fn(table.with_feats(f), rois, valid, OUT, sr, level)
        (out.float() * torch.linspace(-1, 1, out.numel()).reshape(
            out.shape)).sum().backward()
        grads.append(f.grad)
    assert torch.equal(grads[0], grads[1])
    assert grads[0].abs().max() > 0


@pytest.mark.parametrize("nb,caps,sr", [CASES[1], CASES[2], CASES[4]])
def test_plain_gradient_matches_central_differences(nb, caps, sr):
    """gradcheck of the plain version's gradient on float64 rows (two
    levels, missing corners, samples off the grid, an invalid roi; a unit
    of 2). The pooler is linear in the rows, so central differences are
    exact but for the plain version's float32 bin sums (about 1e-7 of an
    output): a step of 1e-2 keeps that under 1e-5 of a derivative."""
    table, rois, valid, level = _case(nb, tuple(c // 4 for c in caps),
                                      torch.float64, seed=7)
    f = table.feats.clone().requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x: roi_align_plain(table.with_feats(x), rois, valid, OUT, sr,
                                  level), (f,), eps=1e-2, atol=1e-4,
        rtol=1e-4)


def test_the_kernels_take_cuda_tensors_only():
    """The kernels' wrappers and the Function refuse CPU tensors (no
    fallback: CPU tensors take the plain version before them)."""
    table, rois, valid, level = _case(2, (200, 100), torch.float32)
    t = table.stacked()
    keys = t.keys.reshape(2, -1)
    flat = (rois.reshape(-1, 7), valid.reshape(-1),
            level.reshape(-1).to(torch.int32))
    grad = torch.zeros((12,) + OUT + (3,))
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_cuda(t.feats.reshape(-1, 3), keys, *flat, t.spatial_size,
                       OUT, 2)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_pairs_cuda(keys, *flat, t.spatial_size, OUT, 2)
    with pytest.raises(ValueError, match="CUDA"):
        roi_align_bwd_cuda(grad, keys, *flat, t.spatial_size, OUT, 2)
    with pytest.raises(ValueError, match="CUDA"):
        RotatedROIAlign.apply(t.feats, t, *flat, OUT, 2)
