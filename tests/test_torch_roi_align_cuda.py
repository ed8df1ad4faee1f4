"""The ROI pooler's kernels (csrc/roi_align.cu) against the plain
version, on the card. Every test carries the ``cuda`` marker and skips
where ``torch.cuda.is_available()`` is false; the file imports nothing of
JAX (run it with ``--noconftest``):

    python -m pytest --noconftest -p no:randomly -q tests/test_torch_roi_align_cuda.py

Tolerances: the forward in f32 within 1e-5 of the largest output (the
same products, summed in another order); in bf16 each bin within one
bf16 step of the plain version on the rows in f32 (the kernel rounds
its f32 sum once; the plain version rounds each weight and product to
bf16, so it is held against the f32 sum instead). The backward in f32
within 1e-5 of the largest gradient of the plain version's autograd (its
sums in another order), the same bits on every call (no atomics). A
unit gives each building the bits it gets alone, forward and backward,
a graph replay the eager bits.
"""

import numpy as np
import pytest
import torch

from chip_smoke import tiny_3g6c_config, tiny_config, tiny_scene
from detection_3d_tpu_torch.ops import cuda_lib
from detection_3d_tpu_torch.ops.roi_align import (
    roi_align_bwd_cuda, roi_align_cuda, roi_align_plain,
    roi_align_rotated_sparse)
from torch_roi_cases import roi_boxes, roi_table

pytestmark = pytest.mark.cuda

OUT = (6, 8, 4)
# (name, buildings, level caps, grid, C, rois a building, sampling ratio,
# roi sizes): the served pooler (two ROI levels, R 1,000, C 128), the
# 3g6c training step's (512 rois), an odd C (one channel a lane) with a
# ratio of 1, a ratio of 3, one level
SHAPES = [
    ("served", 1, (32768, 16384), (256, 256, 32), 128, 1000, 2, (1.0, 24.0)),
    ("training", 1, (32768, 16384), (256, 256, 32), 128, 512, 2,
     (1.0, 24.0)),
    ("odd C, ratio 1", 2, (3000, 1500), (64, 48, 32), 37, 300, 1,
     (0.3, 12.0)),
    ("ratio 3", 2, (3000, 1500), (64, 48, 32), 16, 200, 3, (0.3, 12.0)),
    ("one level", 1, (5000,), (64, 48, 32), 32, 300, 2, (0.3, 12.0)),
]


@pytest.fixture
def dev():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, nb, caps, grid, c, r, size, dtype, seed=0):
    table = roi_table(nb, caps, c, grid, seed, dtype, dev)
    rois, valid, level = roi_boxes(nb, r, len(caps), grid, size, seed, dev)
    return table, rois, valid, level


def _rel(got, want):
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max().clamp(min=1e-30)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,nb,caps,grid,c,r,sr,size", SHAPES)
def test_roi_align_matches_plain(dev, name, nb, caps, grid, c, r, sr, size,
                                 dtype):
    """The forward against the plain version (module docstring's
    tolerances), one launch a call, invalid rois zero, and the same bits
    on a second call."""
    table, rois, valid, level = _case(dev, nb, caps, grid, c, r, size, dtype)
    before = cuda_lib.launches["roi_align"]
    got = roi_align_rotated_sparse(table, rois, valid, OUT, sr, level)
    torch.cuda.synchronize()
    assert cuda_lib.launches["roi_align"] == before + 1
    assert got.dtype == dtype and got.shape == rois.shape[:-1] + OUT + (c,)
    ref = roi_align_plain(table.with_feats(table.feats.float()), rois,
                          valid, OUT, sr, level)
    assert ref.abs().max() > 0.1            # rois really meet voxels
    if dtype == torch.float32:
        assert _rel(got, ref) <= 1e-5, _rel(got, ref)
    else:
        err = (got.float() - ref).abs()
        tol = ref.abs() * 2 ** -7 + 1e-5 * ref.abs().max()
        assert bool((err <= tol).all()), (err - tol).max().item()
    assert not got[~valid].any()
    again = roi_align_rotated_sparse(table, rois, valid, OUT, sr, level)
    assert torch.equal(again, got)


def _bwd(t, rois, valid, level, g):
    """The backward kernels on one table or a unit: (nb * V, C)."""
    t = t.stacked()
    return roi_align_bwd_cuda(
        g.reshape(-1, *OUT, g.shape[-1]).contiguous(), t.keys.contiguous(),
        rois.reshape(-1, 7).contiguous(), valid.reshape(-1).contiguous(),
        level.reshape(-1).to(torch.int32).contiguous(), t.spatial_size, OUT,
        2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_unit_equals_buildings_alone(dev, dtype):
    """A unit of 4 gives each building the bits it gives alone, the
    pooled bins and the rows' gradient."""
    table, rois, valid, level = _case(dev, 4, (8000, 4000), (128, 96, 32),
                                      128, 400, (1.0, 16.0), dtype, seed=2)
    unit = roi_align_rotated_sparse(table, rois, valid, OUT, 2, level)
    g = torch.randn(unit.shape, device=dev,
                    generator=torch.Generator(dev).manual_seed(3)).to(dtype)
    d = _bwd(table, rois, valid, level, g).reshape(4, table.capacity, -1)
    for b in range(4):
        one = roi_align_rotated_sparse(table.building(b), rois[b], valid[b],
                                       OUT, 2, level[b])
        assert torch.equal(one, unit[b]), b
        assert torch.equal(_bwd(table.building(b), rois[b], valid[b],
                                level[b], g[b]), d[b]), b


def test_roi_align_reads_nothing_of_an_invalid_roi(dev):
    """Invalid rois write zeros without reading a row: every row NaN, one
    roi that meets voxels valid (NaN), the others exactly 0; a missing
    corner reads no row either (a valid roi wholly off the grid pools
    0)."""
    table, rois, valid, level = _case(dev, 1, (3000, 1500), (64, 48, 32),
                                      32, 50, (1.0, 8.0), torch.float32)
    every = torch.ones_like(valid)
    meets = roi_align_rotated_sparse(table, rois, every, OUT, 2, level)
    k = 2 + int(meets[2:].flatten(1).any(1).nonzero()[0])
    nan = table.with_feats(torch.full_like(table.feats, float("nan")))
    valid = torch.zeros_like(valid)
    valid[0] = valid[k] = True              # roi 0 lies off the grid
    got = roi_align_rotated_sparse(nan, rois, valid, OUT, 2, level)
    assert not got[0].any()
    assert bool(got[k].isnan().any())
    assert not got[~valid].any()


@pytest.mark.parametrize("nb", [1, 2])
def test_roi_align_backward_matches_plain_autograd(dev, nb):
    """The backward (f32) within 1e-5 of the largest gradient of the
    plain version under autograd, one roi_align_bwd launch, and the same
    bits again."""
    table, rois, valid, level = _case(dev, nb, (8000, 4000), (128, 96, 32),
                                      64, 300, (1.0, 16.0), torch.float32,
                                      seed=4)
    grads = []
    cot = None
    for fn in (roi_align_rotated_sparse, roi_align_plain):
        f = table.feats.clone().requires_grad_()
        out = fn(table.with_feats(f), rois, valid, OUT, 2, level)
        if cot is None:
            cot = torch.randn(out.shape, device=dev,
                              generator=torch.Generator(dev).manual_seed(1))
        before = cuda_lib.launches["roi_align_bwd"]
        grads.append(torch.autograd.grad(out, f, cot)[0])
        if fn is roi_align_rotated_sparse:
            assert cuda_lib.launches["roi_align_bwd"] == before + 1
    assert grads[1].abs().max() > 0.1
    assert _rel(grads[0], grads[1]) <= 1e-5, _rel(grads[0], grads[1])
    assert torch.equal(_bwd(table, rois, valid, level, cot).reshape(
        grads[0].shape), grads[0])


def test_roi_align_bwd_in_bf16_rounds_once(dev):
    """A bf16 gradient: the backward's f32 sums rounded once, so bit
    equal to the f32 backward of the same values rounded to bf16."""
    table, rois, valid, level = _case(dev, 1, (8000, 4000), (128, 96, 32),
                                      128, 300, (1.0, 16.0), torch.bfloat16,
                                      seed=6)
    g = torch.randn(rois.shape[:-1] + OUT + (128,), device=dev,
                    generator=torch.Generator(dev).manual_seed(2)).to(
                        torch.bfloat16)
    d16 = _bwd(table, rois, valid, level, g)
    d32 = _bwd(table, rois, valid, level, g.float())
    assert d16.dtype == torch.bfloat16 and d32.abs().max() > 0.1
    assert torch.equal(d16, d32.to(torch.bfloat16))


def test_roi_align_graph_replay_equals_eager(dev):
    """The forward captured in a CUDA graph and replayed on new rows and
    rois gives the eager bits, every call."""
    cases = []
    for seed in (1, 2):
        t, rois, valid, level = _case(dev, 2, (3000, 1500), (64, 48, 32),
                                      128, 200, (1.0, 12.0), torch.bfloat16,
                                      seed)
        cases.append((t.feats.reshape(-1, 128), t.keys, rois.reshape(-1, 7),
                      valid.reshape(-1), level.reshape(-1).to(torch.int32)))
    grid = (64, 48, 32)

    def run(xs):
        return roi_align_cuda(*xs, grid, OUT, 2)

    static = [x.clone() for x in cases[0]]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        run(static)                         # builds and loads the library
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run(static)
    for xs in (cases[1], cases[0], cases[1]):
        for s, x in zip(static, xs):
            s.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, run(xs))


def test_roi_align_refuses_rois_with_a_gradient(dev):
    """On the card the rois are constants: rois that want a gradient
    raise (the Function would give them none)."""
    table, rois, valid, level = _case(dev, 1, (3000, 1500), (64, 48, 32),
                                      16, 20, (1.0, 8.0), torch.float32)
    with pytest.raises(ValueError, match="no gradient"):
        roi_align_rotated_sparse(table, rois.requires_grad_(), valid, OUT, 2,
                                 level)


def _count_pool_calls(monkeypatch):
    from detection_3d_tpu_torch.models import roi_head
    calls = []
    pool = roi_head.pool_rois

    def counted(*a, **k):
        calls.append(1)
        return pool(*a, **k)

    monkeypatch.setattr(roi_head, "pool_rois", counted)
    return calls


@pytest.mark.parametrize("grouped", [False, True])
def test_one_launch_a_pool_rois_call(dev, monkeypatch, grouped):
    """A served forward launches the forward kernel once a pool_rois
    call; a training step launches one forward and one backward a
    pool_rois call (the 3G6c groups: one call a group); a graphed
    predict gives the eager one's bits."""
    from detection_3d_tpu_torch.engine.inference import make_predict_fn
    from detection_3d_tpu_torch.engine.trainer import (
        batch_to_device, pad_scene, total_loss)
    from detection_3d_tpu_torch.models.detector import (
        SparseRCNN, voxelize_points)
    cfg = tiny_3g6c_config() if grouped else tiny_config()
    calls = _count_pool_calls(monkeypatch)
    model = SparseRCNN(cfg, seed=0).to(dev)
    batch = pad_scene(cfg, tiny_scene(cfg, 0))
    eager = make_predict_fn(cfg, model, dev, graph=False)
    graphed = make_predict_fn(cfg, model, dev)
    # the raw form voxelizes by atomics (test_torch_cuda_graphs.py): both
    # sides under torch's deterministic algorithms
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        cuda_lib.reset_launches()
        want = eager(batch)
        assert cuda_lib.launches["roi_align"] == len(calls) > 0
        assert cuda_lib.launches["roi_align_bwd"] == 0
        for _ in range(3):                  # eager, capture, replay
            got = graphed(batch)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    finally:
        torch.use_deterministic_algorithms(False)
    assert graphed.graphed.replays == 2
    calls.clear()
    cuda_lib.reset_launches()
    g = torch.Generator().manual_seed(0)
    pri = {k: torch.rand((n,), generator=g).to(dev)
           for k, n in model.priority_shapes().items()}
    (pts, fts, valid), gt, gtl = batch_to_device(batch, dev)
    losses = model(voxelize_points(cfg, pts, fts, valid), gt, gtl,
                   priorities=pri)
    total_loss(losses).backward()
    torch.cuda.synchronize()
    assert len(calls) == (3 if grouped else 1)
    assert cuda_lib.launches["roi_align"] == len(calls)
    assert cuda_lib.launches["roi_align_bwd"] == len(calls)
    grads = [p.grad for p in model.roi_head.parameters()]
    assert all(x is not None and bool(torch.isfinite(x).all())
               for x in grads)
    assert np.isfinite(float(total_loss(losses).detach()))
