"""The kernel readers on the CPU: the device seconds by program span
(trace.span_kernel_seconds over hand-made records, trace.records over
hand-made profiler events), layer.roofline_by_span, the kernel labels
of the port's sources, the BN and ROI readers (metrics/BN_roofline.py,
ROI_roofline.py) on hand-made runs, and the ROI count of a served
building."""

from __future__ import annotations

import json
import re
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from perfbench import counts, layer, spec, trace
from perfbench.tests import tiny
from perfbench.trace import Record as R

DETECTOR = spec.family(spec.ROOT, "sparse_rcnn")
HBM = 1e12

# a step on thread 1 (a stem nested in itself inside the forward, then
# the backward), a pack on thread 2, and a launch from a thread with no
# span; times in microseconds
SPANS = [R("train.step", 1, 0, 100), R("train.forward", 1, 10, 40),
         R("model.stem", 1, 15, 25), R("model.stem", 1, 16, 18),
         R("train.backward", 1, 40, 90), R("serve.pack", 2, 0, 50)]
LAUNCHES = [R("cudaLaunchKernel", 1, 16.5, 17, 101),
            R("cudaLaunchKernel", 1, 30, 31, 102),
            R("cudaMemcpyAsync", 1, 32, 33, 103),
            R("cudaLaunchKernel", 2, 20, 21, 104),
            R("cudaLaunchKernel", 1, 95, 96, 105),
            R("cudaGraphLaunch", 1, 41, 42, 106),
            R("cudaLaunchKernel", 3, 50, 51, 107),
            R("cudaLaunchKernel", 5, 65, 66, 108)]
KERNELS = [R("void k<ConvForward>", 7, 20, 20.5, 101),
           R("k2", 7, 32, 33, 102), R("Memcpy HtoD (Pageable -> Device)", 8,
                                      33, 35, 103),
           R("k4", 7, 22, 24, 104), R("k5", 7, 96, 97, 105),
           R("g1", 7, 42, 43, 106), R("g2", 7, 43, 45, 106),
           R("k7", 7, 52, 60, 107), R("launched unseen", 7, 70, 71, 999),
           R("k8", 7, 66, 70, 108)]
# the autograd engine's thread 5 runs thread 1's backward (an operation
# nested in another), and at 95, after train.backward closed, one more
OPS = [R("autograd::engine::evaluate_function: MmBackward0", 5, 60, 80,
         forward=1), R("MmBackward0", 5, 61, 79, forward=1),
       R("autograd::engine::evaluate_function: AddBackward0", 5, 94, 99,
         forward=1)]


def test_span_kernel_seconds_on_hand_made_records():
    """Each kernel counts once for every span name open at its launch on
    the launching thread (nested spans and a graph's kernels included);
    a copy, a kernel launched with no span open and one whose launch is
    not recorded count for none."""
    got = trace.span_kernel_seconds(SPANS, LAUNCHES, KERNELS)
    want = {"model.stem": 0.5, "train.forward": 1.5, "train.backward": 3.0,
            "train.step": 5.5, "serve.pack": 2.0}
    assert got == pytest.approx({k: v / 1e6 for k, v in want.items()})
    assert trace.span_kernel_seconds(SPANS, [], KERNELS) == {}


def test_span_kernel_seconds_follow_the_backward_to_its_forward_thread():
    """A launch from the autograd engine's thread inside a backward
    operation counts for the spans open then on the thread whose forward
    it differentiates (once, however deep the operations nest); with no
    operations it counts for none."""
    base = trace.span_kernel_seconds(SPANS, LAUNCHES, KERNELS)
    got = trace.span_kernel_seconds(SPANS, LAUNCHES, KERNELS, OPS)
    assert got == pytest.approx(dict(base, **{
        "train.backward": base["train.backward"] + 4e-6,
        "train.step": base["train.step"] + 4e-6}))
    late = [R("cudaLaunchKernel", 5, 95, 95.5, 109)]
    assert trace.span_kernel_seconds(
        SPANS, late, [R("k9", 7, 96, 97, 109)], OPS) == \
        pytest.approx({"train.step": 1e-6})
    assert trace.span_kernel_seconds(
        [], LAUNCHES, KERNELS, OPS) == {}


def _ev(name, kind, thread, start, end, id, sys_tid, annotation=False,
        fwd_thread=0):
    return NS(name=name, device_type=kind, thread=thread, id=id,
              time_range=NS(start=start, end=end),
              device_resource_id=sys_tid, is_user_annotation=annotation,
              fwd_thread=fwd_thread)


def test_records_tie_launches_to_their_threads():
    """A launch takes the thread of the host operations of its system
    thread; one from a thread whose operations were not recorded is left
    out; the sub-window's own range and device annotations are no
    spans or kernels; an operation with another thread's forward is a
    backward operation, one on its forward's own thread is not."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev(trace.MARK, cpu, 1, 0, 100, 1, 118, annotation=True),
        _ev("model.stem", cpu, 1, 10, 20, 2, 118, annotation=True),
        _ev("MaskedBatchNorm", cpu, 1, 11, 12, 3, 118),
        _ev("cudaLaunchKernel", cpu, 1, 11.5, 11.8, 50, 118),
        _ev("cudaLaunchKernel", cpu, 1, 13, 14, 51, -5),
        _ev("aten::add_", cpu, 2, 30, 31, 4, 163),
        _ev("cudaLaunchKernel", cpu, 1, 30.2, 30.4, 52, 163),
        _ev("model.stem", cuda, 1, 12, 19, 2, 7, annotation=True),
        _ev("masked_bn_stats_rows", cuda, 1, 12, 13, 50, 7),
        _ev("k", cuda, 1, 14, 15, 51, 7),
        _ev("k2", cuda, 1, 31, 32, 52, 7),
        _ev("train.backward", cpu, 1, 40, 60, 5, 118, annotation=True),
        _ev("MaskedBatchNormBackward", cpu, 3, 41, 50, 6, 171,
            fwd_thread=1),
        _ev("aten::mm", cpu, 1, 41, 42, 7, 118, fwd_thread=1),
        _ev("cudaLaunchKernel", cpu, 3, 42, 43, 53, 171),
        _ev("masked_bn_dx_rows", cuda, 1, 43, 45, 53, 7)]
    spans, launches, kernels, ops = trace.records(events)
    assert spans == [R("model.stem", 1, 10, 20),
                     R("train.backward", 1, 40, 60)]
    assert launches == [R("cudaLaunchKernel", 1, 11.5, 11.8, 50),
                        R("cudaLaunchKernel", 2, 30.2, 30.4, 52),
                        R("cudaLaunchKernel", 3, 42, 43, 53)]
    assert [k.name for k in kernels] == ["masked_bn_stats_rows", "k", "k2",
                                         "masked_bn_dx_rows"]
    assert ops == [R("MaskedBatchNormBackward", 3, 41, 50, forward=1)]
    assert trace.span_kernel_seconds(spans, launches, kernels, ops) == \
        pytest.approx({"model.stem": 1e-6, "train.backward": 2e-6})


def test_roofline_by_span():
    r = NS(sub={"span_kernel_s": {"model.stem": 2e-3,
                                  "model.encoder": 3e-3}})
    assert layer.roofline_by_span(r, ["model.stem"], 1e-3) == \
        pytest.approx(50.0)
    assert layer.roofline_by_span(r, ["model.stem", "model.encoder"],
                                  1e-3) == pytest.approx(20.0)
    assert layer.roofline_by_span(r, ["model.head"], 1e-3) is None
    assert layer.roofline_by_span(r, ["model.stem"], None) is None
    r.sub = {"span_kernel_s": {}}
    assert layer.roofline_by_span(r, ["model.stem"], 1e-3) is None
    r.sub = None
    assert layer.roofline_by_span(r, ["model.stem"], 1e-3) is None


def _port_kernels():
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for path in (spec.ROOT / "detection_3d_tpu_torch" / "csrc").glob("*.cu"):
        text = path.read_text()
        names |= set(re.findall(
            r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(?:void\s+)?(\w+)\s*\(", text))
    return sorted(names)


def test_labels_keep_their_meaning():
    """The symbols BN and ROI came last: every kernel an earlier symbol
    names keeps its label, and BN and ROI name their own kernels alone."""
    kernels = _port_kernels()
    assert "masked_bn_dx" in kernels and "roi_align_rotated_fwd" in kernels
    before = {k: v for k, v in trace.SYMBOLS.items() if k not in ("BN",
                                                                 "ROI")}
    assert list(trace.SYMBOLS)[-2:] == ["BN", "ROI"]
    for name in kernels + ["void (anonymous namespace)::masked_bn_stats_rows"
                           "<__nv_bfloat16, 8>(__nv_bfloat16 const*, int)"]:
        old = next((k for k, sym in before.items() if sym in name), None)
        got = trace.label(name)
        if old is not None:
            assert got == old, name
        assert (got == "BN") == ("masked_bn_" in name), name
        assert (got == "ROI") == ("roi_align_rotated_" in name), name


def _run(kernel, seconds, work):
    return NS(sub={"kernel_s": {kernel: seconds}}, peaks={"hbm": HBM},
              esize=2, window={"sub_buildings": [0, 0]}, work=[work])


def test_bn_reader():
    """Each site's passes over its valid rows (forward 2, a training step
    5), esize bytes an element, over the bandwidth, over BN's device
    time; None without sites, a sub-window or BN's time."""
    read = spec.metric_reader(spec.ROOT, "BN_roofline.seg_train")
    sites = [counts.bn_site(1000, 32, True), counts.bn_site(200, 64, False)]
    least = 2 * 2 * (5 * 1000 * 32 + 2 * 200 * 64) / HBM
    r = _run("BN", 1e-6, {"bn_sites": sites})
    assert read(r) == pytest.approx(100.0 * least / 1e-6)
    assert read(_run("BN", 1e-6, {})) is None
    assert read(_run("BN", 0.0, {"bn_sites": sites})) is None
    r.sub = None
    assert read(r) is None


def test_roi_reader():
    """Each call's pooled output written and its merged table (features
    and int64 keys) and rois read once, over the bandwidth, over ROI's
    device time; None without calls, a sub-window or ROI's time."""
    read = spec.metric_reader(spec.ROOT, "ROI_roofline.single")
    pools = [counts.roi_pool(100, 192, 128, 5000)]
    each = 100 * 192 * 128 * 2 + 5000 * (128 * 2 + 8) + 100 * 28
    r = _run("ROI", 1e-6, {"roi_pools": pools})
    assert read(r) == pytest.approx(100.0 * 2 * each / HBM / 1e-6)
    assert read(_run("ROI", 1e-6, {})) is None
    assert read(_run("ROI", 0.0, {"roi_pools": pools})) is None
    r.sub = None
    assert read(r) is None


def test_roi_count_of_a_served_building():
    """6c_fpn4321's served building: 1,000 rois of 6 x 8 x 4 bins of 128
    bf16 channels from the merged table of its two pooled levels' valid
    rows. With every row valid (32,768 and 16,384) that is 0.0186 ms at
    3.35 TB/s, the kernel table's bound; padding rows count for nothing.
    3G6c pools once a group."""
    def pyramid(caps, valid):
        return {"tables": [NS(capacity=c, row_valid=np.arange(c) < v)
                           for c, v in zip(caps, valid)]}

    for name, groups in (("6c_fpn4321", 1), ("3g6c_fpn4321", 3)):
        file = json.loads((spec.HERE / "configs" / f"{name}.json")
                          .read_text())
        cfg = DETECTOR.reference_config(file)
        caps = cfg.caps.voxel_caps
        pools = DETECTOR.roi_pools(cfg, pyramid(caps, caps))
        assert len(pools) == groups
        if groups == 1:
            assert pools == [counts.roi_pool(1000, 192, 128, 49152)]
            peak = counts.PEAKS["NVIDIA H100 80GB HBM3"]["hbm"]
            assert counts.roi_bytes(pools, 2) / peak * 1e3 == \
                pytest.approx(0.0186, abs=5e-5)
            half = DETECTOR.roi_pools(cfg, pyramid(caps, [c // 2
                                                          for c in caps]))
            assert half == [counts.roi_pool(1000, 192, 128, 24576)]


def test_work_counts_the_pooler_of_a_served_forward_alone():
    """building_work gives a served forward's pooler calls, over the
    pooled levels' valid rows, and none for a training step."""
    from perfbench.reference.config import Config
    cfg = spec.build_config(Config, {"model": tiny.tiny_model()})
    n = 9
    xy = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                  -1).reshape(-1, 2)
    pts = (np.concatenate([xy, np.zeros((len(xy), 1))], 1) + 0.5) * 0.02
    scene = {"points": pts.astype(np.float32),
             "feats": np.ones((len(xy), 9), np.float32),
             "gt_boxes": np.zeros((0, 7), np.float32),
             "gt_labels": np.zeros((0,), np.int32)}
    padded = DETECTOR.reference_pad(cfg, scene)
    served = DETECTOR.building_work(cfg, padded, "cpu")
    from perfbench.reference.backbone import build_pyramid
    from perfbench.reference.detector import voxelize_points
    pyr = build_pyramid(voxelize_points(
        cfg, *(torch.as_tensor(padded[k]) for k in
               ("points", "feats", "points_valid"))), cfg)
    top = cfg.sparse3d.num_scales - 1
    rows = sum(int(pyr["tables"][top - s].row_valid.sum())
               for s in cfg.roi.pooler_scales_from_top)
    assert 0 < rows < sum(pyr["tables"][top - s].capacity
                          for s in cfg.roi.pooler_scales_from_top)
    assert served["roi_pools"] == [counts.roi_pool(
        cfg.rpn_post_nms_top_n_test, int(np.prod(cfg.roi.pooler_resolution)),
        cfg.sparse3d.nplane_map, rows)]
    assert "roi_pools" not in DETECTOR.building_work(cfg, padded, "cpu",
                                                     train=True)
