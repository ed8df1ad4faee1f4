#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (detection_3d_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --bwd-shapes   # only the backward at every
                                         # training shape (phase 5's)
    python3 chip_smoke.py --compare      # only D at every book and the
                                         # pyramid's host time, in any
                                         # tree of the package
    python3 chip_smoke.py --d-forms      # only D's three forms at every
                                         # book
    python3 chip_smoke.py --overfit      # only the overfit gate with the
                                         # 3G6c groups (4000 steps)
    python3 chip_smoke.py --parallel     # only the multi-device phase (7b)
    python3 chip_smoke.py --batched      # only the batched-serving phase
    python3 chip_smoke.py --minkunet     # only MinkUNet34C's phase (4d)
    python3 chip_smoke.py --bn           # only the masked BN kernels at
                                         # the main paths' sites
    python3 chip_smoke.py --roi          # only the ROI pooler's kernels
                                         # at the main paths' shapes

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's eight CUDA sources from detection_3d_tpu_torch/csrc
   (one nvcc per source, all started together) and, beside them, the C++
   pyramid packer and scene loader (g++), and prints the build time.
3. Holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes taken from a full-size synthetic building,
   whose pyramid (serving and training forms) must take every
   submanifold row order from kernel B's masks, never from row_masks:
   A (gather-conv, with the rulebook's row order and with rows in a
   random order) and the backward A' (dFeats through A's code on the
   transposed book, the dW kernel; the same bits on two calls) on the
   scale-0 and scale-1 rulebooks in f32 and bf16; B (submanifold match:
   8 column searches a site, in shared-memory windows or, on tables
   under 65536 rows, over the whole table; and the row masks) at each of
   the building's 9 table sizes (V = 524288 .. 2048), book and masks bit
   exact in both forms, the same bits twice, with its window counts,
   event and profiler times and a per-building sum; C (rotated IoU) bit for
   bit on an adversarial box set (every criterion, with and without the
   same-box fix) and on 2000 x 2000 boxes for criteria -1/0/1/2 with
   identical greedy NMS keep sets; D (query-key match: a 4-ary search
   for small query sets, warp compaction for large deconv ones, a binary
   search otherwise; one launch a call) on the queries of
   every conv and deconv book of the building and on the scale-0 conv
   queries shuffled, bit exact against its plain version, with the
   scale-0 books equal to the scatter-derived ones, timed per book and
   summed per pyramid. Prints kernel, plain and bound times, and for B
   and D torch.searchsorted over the same queries.
4. Serving path at full width: full_scale_config(), seeded random
   weights, make_predict_fn + run_inference over 4 buildings of 500k
   points; checks finite outputs, true_num > 0 and that every serving
   kernel was launched. Prints s/building, the stages of one more from
   the span log of a profiled call (host seconds and syncs), and
   kernel A at every distinct shape that building launched (against its
   plain version, with its launches, bound and mean offsets per tile
   with and without the row order).
4b. Packed forms and pipelined serving at full width: one building's
   host pyramid (the C++ packer, byte for byte against the numpy one)
   unpacked on the card against build_pyramid on the same pack's table,
   every table, book and row order bit equal (per-field mismatch counts
   printed); its host pack times (numpy and C++, table and pyramid, the
   C++ pyramid on 1/2/4/8 threads), bytes and copy times (pageable and
   pinned); 6 buildings through the sequential predict of each packed
   form (points, table, pyramid: table and pyramid within 1e-4, points
   against table as sets, equal true_num); then
   run_inference(pipelined=True) with 2 pack workers in pyramid and
   table mode at batch 1 and 2, alternating with the raw sequential
   loop, each within 1e-6 of the sequential packed predict, with
   s/building, timings, idle share, peak memory and launches (A and C
   in every run, B in table mode only).
4c. Batched serving at full width (this slice's path): 8 buildings of
   500k points through make_batch_predict_fn (table mode) at B = 1, 2
   and 4, one forward a unit: each unit's detections within 1e-4 (as
   sets) of the per-building predict on the card, its launches exactly
   A 38, B 9, C 2 and E 2 whatever B (counts set to 0 before the unit
   and read after), its host syncs (torch's sync debug mode; none may
   remain), busy ms and idle share (utils/profiling.device_activity) and
   the peak memory; then run_inference(pipelined=True) at each B for
   s/building and buildings/s. At the B = 4 unit's shapes: A on the flat
   scale-0 book (f32 bit equal to each building's own call), B over the
   4 stacked tables (bit exact, and against each table's own launch), C
   at the unit's two NMS calls (bit exact matrix by matrix) and E, the
   greedy NMS pass over the float32 IoU (identical keep sets against the
   torch compare and numpy pass, also on 2000^2 and 1000^2 cases with
   ties, entries at the threshold, beside it and NaN, an all-invalid
   matrix, and one 20000^2 matrix for the walk above N = 8192), each
   timed beside its plain version and bound; E also beside
   the torch compare it absorbs and its walk's serial floor.
4d. MinkUNet34C at its published widths on one dense room (one 8 m room
   of 500k points, the segmentation cell's shape): kernel B's 5x5x5 form
   bit exact against its plain column twin, kernel A over the stem's
   125-offset book (two-word row masks) in f32 and bf16 and the stem's
   dW over its entries-only book against their plain versions, each
   timed; then one Trainer.step's launches after a warm-up step: B 6,
   A 55, dFeats 54, dW 55.
5. Training path at full width: a Trainer on the card takes 6 steps over
   6 such buildings (bf16 compute, SparseRCNN(cfg, seed=0)); checks
   finite losses, applied steps, moved parameters and that A, both A'
   kernels, B and C were launched. Prints s/step (the trainer's history:
   a scene's fetch and padding through its losses on the host), padding
   alone, peak memory, the losses of each step and a device profile of
   one more step. One more step
   keeps the inputs of every backward call: at each distinct shape,
   dFeats and dW are held against gather_conv_backward, run twice for
   identical bits and timed beside it, with a per-step sum of each, and
   build_pyramid is timed with and without the backward books. One
   step more keeps the inputs of its kernel C calls (RPN targets:
   max_gt x every anchor, criterion 2; the RPN's NMS; ROI targets:
   max_gt x decoded proposals and gt, criterion -1), and each call is
   held bit for bit against its plain version on every pair, in
   4096-column chunks, and timed.
5b. The training input path at full width: the 6 buildings written as
   scene packs (bytes, write time) and read back through the C++
   NativeSceneLoader (equal to read_scene_pack); one epoch over the
   loader and one over the list, alternating, twice each with the same
   seed (the same scene order, finite and applied steps, s/step); one
   building's training pack (pack_pyramid_native(..., backward=True))
   byte for byte against the numpy one and unpacked on the card against
   build_pyramid(..., backward=True), every BackwardBook field bit equal
   (per-field mismatch counts), with the backward fields' bytes and the
   pack times with and without them; the packed training forward and
   backward against the table-form one with the same weights and draws
   (under torch's deterministic algorithms the same bits, losses and
   gradients, as the table form against itself; in the default mode the
   losses within 1e-4 and the gradients' spread printed); Trainer.step(packed=
   "pyramid"); train_resident over the 6 buildings, chunk 6, 2 epochs
   (pack time, resident MB, s/step per chunk, peak memory, non-finite
   count, one more chunk under the profiler); scan_steps = 3 over the
   list. A, dFeats, dW and C must launch on every one of these paths, B
   on the loader, list and scanned ones and not on the packed and
   resident ones.
6. The train-and-evaluate entry point at full width and depth
   (tools/train_net.train_and_evaluate): 2 train and 2 test houses of
   500k points written in the reference SUNCG format and read back
   through SUNCGDataset (points and boxes equal the buildings within
   1e-2 voxel), one epoch with eval_in_train=1 (finite steps, the
   train-time evaluation's gt counts), the served test houses evaluated
   with kernel C once per (building, class) pair with detections and
   gts (its calls held bit for bit and timed), the same predictions
   evaluated on the CPU (AP, AIoU and rates within 1e-6), and a call with
   only_test that resumes from the checkpoint tag (parameters bit equal,
   detections within 1e-4). Prints the evaluator's host s/building, its
   kernel C launches and the eval-in-train step times.
6b. The separate-classifier (3G6c) configuration: full_scale_config()
   with the groups (("wall",), ("ceiling", "floor")) (3 groups, the
   reference's 6c_Fpn4321 topology at full width and depth, seeded
   random weights) serves 3 buildings through run_inference (labels
   the original ids 1..5, finite, 3 x 100 rows) and trains 4 Trainer
   steps (12 finite losses, moved parameters); A, dFeats, dW, B and C
   must launch. Prints s/building, s/step, peak memory and C's launches
   per building and per step. Then at the small configs: the grouped
   model's predict and one training step card against CPU (as in 8),
   and an rpn_only model's serve (labels 1, descending objectness) and
   training step on the card.
6c. The generic sparse networks at full width (models/factories.py):
   SparseUNet(nplanes 32..224, reps 2, residual), SparseConvNet's ScanNet
   UNet at m = 32, over plan_levels of one full-size building with level
   caps measured to hold every voxel (x 1.10, printed); a bf16 forward and
   the backward of (out ** 2).sum(), twice (finite outputs and
   gradients; A, dFeats, dW and B launched, counted over the first);
   SparseVGG (C, C, MP / C3/2 a level) and FullyConvolutionalNet forward
   on the same plan; A, dFeats and dW at the UNet's level-0 and deepest
   shapes against their plain versions, with bounds; and a small UNet
   and VGG card against CPU (books bit equal, f32 outputs and gradients).
   Prints s per forward and backward, peak GiB and launches.
6d. Dataset preparation: a SUNCG-format house of 5 x 5 rooms
   (tests/torch_house_cases.py) through parse_house_file,
   refine_house_boxes and house_point_cloud(method="render", 500k
   points), written as a reference-format .pth, read back through
   SUNCGDataset and trained one full-width step on the card; each
   stage's host seconds, box counts by class and the point count.
6e. rotate_nms_3d on 2000 boxes (kernel C; keep set equal to nms_boxes
   on the card and on the CPU), and conv_rulebook / deconv_rulebook
   (kernel D) on the building's scale-0 -> 1 tables, bit equal to the
   scatter books.
6f. The repo-level tools' twins (detection_3d_tpu_torch/tools/) on the
   card: the bench twin's run (tools/bench.run: host pack, device time of
   5 pyramid predicts, the stream of 4 buildings in table and pyramid
   mode and at batch 2) with its JSON line parsed and held (every key of
   bench.py's line and the twin's own, finite positive times, the card's
   name, an idle share in [0, 1], detections for every building); its
   parity checks at full scale (B, A, the searched books through D);
   train_bench at gen_config() (3 steps, A, dFeats, dW, B and C
   launched); profile_inference at full width (positive stage times, the
   full prefix within 1e-6 of make_predict_fn); diag_anchor_coverage on
   seed 0 at gen_config() on the card and on the CPU (equal per-class
   counts, gts within 1e-5 of the threshold named and excepted); and
   clean_models over a directory of model_*.pt files. The pipelined runs
   of 4b print the device's busy time as the union over every stream
   (utils/profiling.device_activity) beside the old sum, and the idle
   share by each.
7. D's own path: conv_rulebook_match / deconv_rulebook_match over every
   downsample of a full-size building's pyramid, bit exact against the
   scatter-derived books.
7b. The multi-device phase at full width (parallel/mesh.py,
   parallel/spatial.py), each part in rank processes started by
   parallel.mesh.launch (NCCL over distinct cards where there are as
   many cards as ranks, else gloo with every rank on cuda:0; the kernels
   built before): data parallelism on 2 ranks, 3 steps of one building
   a rank (the first, under deterministic algorithms with given draws,
   held against one process's step over the same two buildings: losses
   within 1e-4, gradients within 1e-3 of the largest + 1e-5; the
   parameters' digest equal on every rank after every step); spatial
   sharding of one building (moved to the grid's middle) over 2 x-slabs
   with shard and halo caps measured from the single-card pyramids, and
   voxel caps that hold the building (full_scale_config()'s subsample
   scale 1, which a shard would do otherwise) for both sides (the
   gathered maps against one card's, the same rows and the largest
   relative feature difference; kernel D on every book of each shard
   pyramid bit exact against its plain version and timed; the bytes the
   exchanges move a forward; spatial_predict and a spatial train step
   with s/building, s/step and peak memory against one card; at the
   small config, detections as sets and gradients against one card);
   dp x sp = 2 x 2 over two buildings (two full-width steps; the small
   config's gradients against the mean of the two buildings' one-card
   gradients). Every rank must launch A, B, C and D (a data-parallel
   rank: A, dFeats, dW, B and C), and a training one also dFeats and
   dW.
8. Small inputs, card against CPU: one building through predict, and one
   training step with the same weights and sampler draws (losses and
   every gradient).
8b. The masked BN kernels at the main paths' sites (--bn), then the ROI
   pooler (csrc/roi_align.cu, --roi) at the pooler calls of one served
   building, a unit of 4 and a 3G6c training forward: the forward
   against the plain version on the rows in f32 (each bf16 bin within
   one bf16 step), the backward against its autograd (f32), one forward
   launch a pool_rois call and one backward on the training path; the
   device ms of each kernel beside the plain version's and the bound
   (the bytes that must move, and the corner rows read from L2). Every
   path through the ROI head must launch the forward (a training path
   the backward too), seg_train and rpn_only neither.
9. Prints the card line, a JSON line of per-kernel numbers and, last,
   {"ok": true, "device": {...}}.

Launch counts are set to 0 just before each path (serve, serve_points,
serve_table, serve_pyramid, pipelined_table, pipelined_pyramid, train,
train_loader, train_list, train_packed, train_resident, train_scan,
eval, serve_3g6c, train_3g6c, rpn_only, zoo, zoo_vgg, zoo_fcn,
dataprep, api_nms, api_books, bench_table, bench_pyramid, bench_batch,
bench_parity, train_bench, profile_inference, diag, match, seg_train
(one MinkUNet34C step), and in each
rank dp_train,
sp_serve, sp_train, dpsp_train) and read just after;
launches made to compare a kernel with its plain version do not count.
Any failed phase raises and exits non-zero; without CUDA, or without the
package beside it, the script exits non-zero before printing a result.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense, /s
SCALAR_OPS = 67e12               # f32 outside the tensor cores
# per-pair scalar operations of kernel C's hull over all 24 candidates,
# counted from csrc/rotated_iou.cu: corners 52, point-in-quad 176, edge
# intersections 784, centroid 98, keys 264, ranks 1656, successor search
# 1272, criteria ~10 (the compacted searches do fewer for most pairs)
IOU_OPS_PER_PAIR = 4312
BUILDINGS = 4            # the first warms up, the other three are timed
TRAIN_STEPS = 6          # the first warms up, the other five are timed
POINTS = 500_000         # per synthetic building (bench.py's smoke size)


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def card_line():
    from detection_3d_tpu_torch.utils.device import card_info
    return card_info()["line"]


def time_ms(fn, iters=10):
    """Mean device time of one call, CUDA events over ``iters`` calls after
    one warm-up call (inputs stay warm in L2 between calls)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, symbols, iters=10, expect=None):
    """Mean device time per call of ``fn`` spent in kernels whose names
    hold one of ``symbols`` (every device activity where ``symbols`` is
    None), from torch.profiler over ``iters`` calls after a warm-up call.
    Where those kernels are shorter than the host takes to launch them,
    :func:`time_ms` measures the launch rate and this the kernels. None
    when two profiles in a row record none of those kernels.

    ``expect``: the kernels of ``symbols`` that one call launches. The
    profile then runs one call more, first, and takes the last ``iters *
    expect`` of them; a profile that records fewer is not taken (the
    profiler lost activity records), a line says how many it recorded
    and how many kernel launches the host made, and None is returned
    when two in a row fall short: no number rather than a low one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters + (expect is not None)):
                fn()
            torch.cuda.synchronize()
        events = prof.events()
        evs = sorted((e for e in events
                      if getattr(e, "device_type", None) == DeviceType.CUDA
                      and (symbols is None
                           or any(sym in e.name for sym in symbols))),
                     key=lambda e: e.time_range.start)
        if expect is not None:
            want = iters * expect
            if len(evs) < want:
                launched = sum(
                    1 for e in events
                    if getattr(e, "device_type", None) == DeviceType.CPU
                    and e.name.startswith("cudaLaunchKernel"))
                print(f"device_ms {symbols}: the profiler recorded "
                      f"{len(evs)} of {want + expect} kernels over "
                      f"{iters + 1} calls ({launched} kernel launches "
                      "recorded on the host): not taken")
                continue
            evs = evs[-want:]
        if evs:
            return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / iters
    return None


def bound(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tiny_config():
    """The parity tests' tiny config (tests/test_torch_common.tiny_cfg).
    Its small training top-n matters to the card-vs-CPU training check:
    at random weights the RPN scores sit near 0.5, and a top-2000 cut
    over them flips under one-ulp differences of the head's matmul."""
    from detection_3d_tpu_torch.config.defaults import (
        CapacityConfig, Config, ROIConfig, RPNConfig, Sparse3DConfig)
    return Config(
        classes=("background", "wall", "door", "window"),
        compute_dtype="float32",
        sparse3d=Sparse3DConfig(
            voxel_scale=20, voxel_full_scale=(256, 256, 64),
            nplanes_front=(8, 16, 16, 32, 32), kernels=((2, 2, 2),) * 4,
            strides=((2, 2, 2),) * 4, nplane_map=16),
        rpn=RPNConfig(
            rpn_scales_from_top=(2, 1), rpn_3d_2d_selector=(0, 1, 2),
            anchor_sizes_3d=((0.2, 0.5, 3), (0.4, 1.5, 3), (0.6, 2.5, 3)),
            use_yaws=(1, 1, 1), fpn_pre_nms_top_n_train=256,
            fpn_pre_nms_top_n_test=256, fpn_post_nms_top_n_train=64,
            fpn_post_nms_top_n_test=64, batch_size_per_image=64),
        roi=ROIConfig(pooler_scales_from_top=(2, 1), batch_size_per_image=64,
                      detections_per_img=32, mlp_head_dim=32),
        caps=CapacityConfig(max_points=8192,
                            voxel_caps=(4096, 2048, 1024, 512, 256),
                            max_gt=16))


def tiny_3g6c_config():
    """:func:`tiny_config` with 6 classes, the 3G6c groups and
    class-matched anchors (a slab on the finest 3D map, a wall, a door),
    as the grouped parity tests have them
    (tests/test_torch_separate_classifier.sep_cfg)."""
    import dataclasses
    from detection_3d_tpu_torch.tools.overfit_check import (
        CLASSES6, GROUPS_3G6C)
    cfg = tiny_config()
    return cfg.replace(
        classes=CLASSES6, separate_classes=GROUPS_3G6C,
        rpn=dataclasses.replace(
            cfg.rpn, anchor_sizes_3d=((6.0, 6.0, 0.8), (0.4, 1.5, 3),
                                      (0.2, 0.5, 3))))


def tiny_scene(cfg, seed=0):
    from detection_3d_tpu_torch.data.synthetic import synthetic_building
    return synthetic_building(seed=seed, num_points=6000, room=6.0,
                              classes=cfg.classes, voxel_scale=20)


def conv_bound(feats, idx, w, valid):
    """Kernel A's bound with a row order: each referenced feature row,
    each real rulebook entry, the order (int32 + int64 mask per row), W
    and out_valid read once and the output written, against 2 * nnz *
    Cin * Cout operations. Returns (ms, bound_by, nnz)."""
    v_in, cin = feats.shape
    k, v_out = idx.shape
    cout = w.shape[2]
    eb = feats.element_size()
    real = (idx < v_in) & valid[None, :]
    nnz = int(real.sum())
    uniq = int(torch.unique(idx[real]).numel())
    nbytes = (uniq * cin * eb + nnz * 4 + v_out * 12 + k * cin * cout * eb
              + v_out + v_out * cout * eb)
    return bound(nbytes, 2.0 * nnz * cin * cout, PEAK_OPS[feats.dtype]) \
        + (nnz,)


def check_gather_conv(dev, table0, table1, crb, idx0, idx1, gen):
    """Kernel A against gather_conv on the card at main-path shapes, with
    the rulebook's row order (as the paths call it) and with the rows in
    a random order (tiles then mix masks); the bf16 scale-0 32->32 case
    (the backbone's commonest) is reported. The bound is
    :func:`conv_bound`."""
    from detection_3d_tpu_torch.ops.sparse_conv import (
        RowOrder, gather_conv, gather_conv_cuda, row_masks,
        rulebook_row_order)
    cases = [("s0 subm 9->32", table0, table0, idx0, 9, 32),
             ("s0 subm 32->32", table0, table0, idx0, 32, 32),
             ("s0->s1 down 32->64", table0, table1, crb, 32, 64),
             ("s1 subm 64->64", table1, table1, idx1, 64, 64)]
    report = None
    for dtype in (torch.float32, torch.bfloat16):
        for name, tin, tout, idx, cin, cout in cases:
            k = idx.shape[0]
            feats = torch.randn((tin.capacity, cin), generator=gen,
                                device=dev)
            feats = (feats * tin.row_valid[:, None]).to(dtype)
            w = (torch.randn((k, cin, cout), generator=gen, device=dev)
                 * (2.0 / (k * cin)) ** 0.5).to(dtype)
            valid = tout.row_valid
            order = rulebook_row_order(idx, tin.capacity, valid)
            perm = torch.randperm(idx.shape[1], generator=gen, device=dev)
            scrambled = RowOrder(perm.to(torch.int32),
                                 row_masks(idx, tin.capacity, valid)[perm])
            want = gather_conv(feats, idx, w, valid).float()
            scale = float(want.abs().max())
            tol = (1e-4 if dtype == torch.float32 else 1e-2) * max(scale, 1.0)
            err = 0.0
            for o in (order, scrambled):
                got = gather_conv_cuda(feats, idx, w, valid, o).float()
                err = max(err, float((got - want).abs().max()))
            check(err <= tol, f"kernel A {name} {dtype}: max abs err {err} "
                  f"> {tol}")
            ms = time_ms(lambda: gather_conv_cuda(feats, idx, w, valid,
                                                  order))
            plain = time_ms(lambda: gather_conv(feats, idx, w, valid), 3)
            b_ms, b_by, _ = conv_bound(feats, idx, w, valid)
            line = {"case": name, "dtype": str(dtype).split(".")[-1],
                    "K": k, "V_in": tin.capacity, "V_out": tout.capacity,
                    "max_abs_err": err, "tolerance": tol, "ms": ms,
                    "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by}
            print("kernel A", json.dumps(line))
            if name == "s0 subm 32->32" and dtype == torch.bfloat16:
                report = line
    return report


def _book_kind(k, v_in, v_out):
    if k == 27 and v_in == v_out:
        return "subm"
    if v_in == v_out:
        return "bev"
    return "down" if v_out < v_in else "up"


def offsets_per_tile(idx, v_in, valid, order, cout):
    """Mean number of offsets kernel A's tiles run (a tile without a
    valid row runs none), in the rows' own order and in ``order`` (tiles
    of 128 rows for Cout <= 32, else 64, as csrc/gather_conv.cu)."""
    from detection_3d_tpu_torch.ops.sparse_conv import row_masks
    bm = 128 if cout <= 32 else 64
    k = idx.shape[0]
    shifts = torch.arange(k, device=idx.device)

    def mean_offsets(masks):
        pad = (-masks.numel()) % bm
        m = torch.cat([masks, masks.new_zeros(pad)]).view(-1, bm)
        bits = ((m[:, :, None] >> shifts) & 1).bool().any(1)
        return float(bits.sum(1).float().mean())
    return {"offsets_per_tile_unordered": mean_offsets(
                row_masks(idx, v_in, valid)),
            "offsets_per_tile_ordered": mean_offsets(order.masks)}


def gather_conv_serving_shapes(predict, batch):
    """Kernel A at every distinct shape the serving path launches it with.

    One building goes through ``predict`` with kernel A's wrapper wrapped
    to keep each call's inputs; then each distinct (book kind, K, V_in,
    V_out, Cin, Cout, dtype) is held against gather_conv on those real
    inputs (1e-2 of the largest value in bf16, 1e-4 in f32) and timed
    beside its plain version. ``launches`` is the number of calls of that
    shape per building. The bound is :func:`conv_bound` (a lower bound:
    the kernel reads the order and masks, and idx only at the offsets a
    tile runs). Each shape also gets the mean offsets its tiles run with
    and without the row order.
    """
    from detection_3d_tpu_torch.ops import sparse_conv as sc
    calls = []
    orig = sc.gather_conv_cuda

    def recorder(*args, **kw):
        calls.append((args, kw))
        return orig(*args, **kw)

    sc.gather_conv_cuda = recorder
    try:
        with torch.inference_mode():
            out, _ = predict(batch)
            out.cpu()
    finally:
        sc.gather_conv_cuda = orig
    groups = {}
    for args, kw in calls:
        feats, idx, w, valid = args[:4]
        check(len(args) > 4 and args[4] is not None, "kernel A: a serving "
              "call came without its rulebook's row order")
        key = (_book_kind(idx.shape[0], feats.shape[0], idx.shape[1]),
               idx.shape[0], feats.shape[0], idx.shape[1], w.shape[1],
               w.shape[2], str(feats.dtype).split(".")[-1])
        groups.setdefault(key, [args, kw, 0])[2] += 1
    rows, total_ms, total_bound = [], 0.0, 0.0
    with torch.inference_mode():
        for key, (args, kw, n) in groups.items():
            feats, idx, w, valid = args[:4]
            got = orig(*args, **kw).float()
            want = sc.gather_conv(*args, **kw).float()
            err = float((got - want).abs().max())
            tol = ((1e-4 if feats.dtype == torch.float32 else 1e-2)
                   * max(float(want.abs().max()), 1.0))
            check(err <= tol, f"kernel A at serving shape {key}: max abs "
                  f"err {err} > {tol}")
            ms = time_ms(lambda: orig(*args, **kw))
            plain = time_ms(lambda: sc.gather_conv(*args, **kw), 2)
            v_in, cin = feats.shape
            k, v_out = idx.shape
            cout = w.shape[2]
            b_ms, b_by, nnz = conv_bound(feats, idx, w, valid)
            offs = offsets_per_tile(idx, v_in, valid, args[4], cout)
            line = {"kind": key[0], "K": k, "V_in": v_in, "V_out": v_out,
                    "Cin": cin, "Cout": cout, "dtype": key[6],
                    "launches": n, "nnz": nnz, "max_abs_err": err,
                    "tolerance": tol, "ms": ms, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, **offs}
            print("kernel A serving shape", json.dumps(line))
            rows.append(line)
            total_ms += n * ms
            total_bound += n * b_ms
    summary = {"calls": len(calls), "shapes": len(rows),
               "sum_ms_per_building": total_ms,
               "sum_bound_ms_per_building": total_bound}
    print("kernel A per building:", json.dumps(summary))
    return rows, summary


def bwd_bound(feats, idx, w, valid):
    """Kernel A′'s bounds on one rulebook, counted on its real entries
    (idx[k, i] a real row, output row i valid), as :func:`conv_bound`
    counts A's: dFeats reads each referenced g row, the transposed book's
    real entries, its row order (int32 + int64 mask per input row) and W
    once and writes dFeats (V_in, Cin); dW reads each referenced feats row
    and g row, the entry pairs (two int32) and the offsets' starts once
    and writes dW. Each does 2 * nnz * Cin * Cout operations. Returns
    ({"dfeats": (ms, bound_by), "dw": (ms, bound_by)}, nnz)."""
    v_in, cin = feats.shape
    k, v_out = idx.shape
    cout = w.shape[2]
    eb = feats.element_size()
    real = (idx >= 0) & (idx < v_in) & valid[None, :]
    nnz = int(real.sum())
    in_rows = int(torch.unique(idx[real]).numel())
    out_rows = int(real.any(0).sum())
    w_b = k * cin * cout * eb
    ops = 2.0 * nnz * cin * cout
    peak = PEAK_OPS[feats.dtype]
    return {"dfeats": bound(out_rows * cout * eb + nnz * 4 + v_in * 12
                            + w_b + v_in * cin * eb, ops, peak),
            "dw": bound(in_rows * cin * eb + out_rows * cout * eb + nnz * 8
                        + (k + 1) * 4 + w_b, ops, peak)}, nnz


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_gather_conv_bwd(dev, table0, table1, crb, idx0, idx1, gen):
    """The backward against gather_conv_backward at the four main-path
    shapes of kernel A, f32 and bf16, with a random upstream gradient:
    dFeats (kernel A's code on the transposed book) and dW (the entry-list
    kernel), each run twice for identical bits. The bf16 scale-0 32->32
    case is reported; the bound is :func:`bwd_bound`.

    Tolerance 1e-4 (f32) and 1e-2 (bf16) of the largest wanted value:
    both sides sum in f32 in other orders, and bf16 results differ by one
    rounding."""
    from detection_3d_tpu_torch.ops.sparse_conv import (
        backward_book, gather_conv_backward, gather_conv_dfeats_cuda,
        gather_conv_dw_cuda)
    cases = [("s0 subm 9->32", table0, table0, idx0, 9, 32),
             ("s0 subm 32->32", table0, table0, idx0, 32, 32),
             ("s0->s1 down 32->64", table0, table1, crb, 32, 64),
             ("s1 subm 64->64", table1, table1, idx1, 64, 64)]
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, tin, tout, idx, cin, cout in cases:
            k = idx.shape[0]
            feats = torch.randn((tin.capacity, cin), generator=gen,
                                device=dev)
            feats = (feats * tin.row_valid[:, None]).to(dtype)
            w = (torch.randn((k, cin, cout), generator=gen, device=dev)
                 * (2.0 / (k * cin)) ** 0.5).to(dtype)
            valid = tout.row_valid
            g = torch.randn((tout.capacity, cout), generator=gen,
                            device=dev).to(dtype)
            want_f, want_w = gather_conv_backward(feats, idx, w, valid, g)
            book = backward_book(idx, tin.capacity, valid)
            run = {"dfeats": lambda: gather_conv_dfeats_cuda(g, w, book),
                   "dw": lambda: gather_conv_dw_cuda(feats, g, book)}
            errs, times = {}, {}
            for part, want in (("dfeats", want_f), ("dw", want_w)):
                got = run[part]()
                check(torch.equal(_bits(got), _bits(run[part]())),
                      f"kernel A' {part} {name} {dtype}: two calls differ")
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                tol = (1e-4 if dtype == torch.float32 else 1e-2) * \
                    max(scale, 1e-30)
                check(err <= tol, f"kernel A' {part} {name} {dtype}: max "
                      f"abs err {err} > {tol}")
                errs[part] = (err, tol)
                times[part] = time_ms(run[part])
            plain = time_ms(lambda: gather_conv_backward(feats, idx, w,
                                                         valid, g), 3)
            bounds, nnz = bwd_bound(feats, idx, w, valid)
            for part in ("dfeats", "dw"):
                ms, (b_ms, b_by) = times[part], bounds[part]
                line = {"case": name, "part": part,
                        "dtype": str(dtype).split(".")[-1], "K": k,
                        "V_in": tin.capacity, "V_out": tout.capacity,
                        "nnz": nnz, "max_abs_err": errs[part][0],
                        "tolerance": errs[part][1], "ms": ms,
                        "plain_ms": plain, "plain_computes": "both parts",
                        "bound_ms": b_ms, "bound_by": b_by,
                        "same_bits_twice": True}
                print("kernel A'", json.dumps(line))
                if name == "s0 subm 32->32" and dtype == torch.bfloat16:
                    report[part] = line
    return report


def gather_conv_bwd_training_shapes(step):
    """Kernel A′ at every distinct shape one training step launches it
    with.

    ``step()`` runs one training step with GatherConv's backward wrapped
    to keep, per call, its inputs (feats, idx, W, out_valid, the upstream
    gradient g) and the calls it makes of the dFeats and dW wrappers.
    Calls are grouped by (book kind, K, V_in, V_out, Cin, Cout, dtype);
    for each shape, on the inputs of its first call, dFeats and dW are
    held against gather_conv_backward (1e-2 of the largest wanted value
    in bf16, 1e-4 in f32), run twice for identical bits and timed beside
    the plain version (gather_conv_backward, both parts in one call):
    ``ms`` with CUDA events, ``device_ms`` the kernels' own time from the
    profiler (:func:`device_ms`; the symbols of this tree's kernels and of
    the kernels before them).
    ``launches`` counts the calls of that shape per step (the input conv
    forms no dFeats). The bound is :func:`bwd_bound`. The replays work on
    any version of the wrappers, so the phase can time another tree of
    the package too (``--bwd-shapes``). Returns (rows, summary)."""
    from detection_3d_tpu_torch.ops import sparse_conv as sc
    names = {"dfeats": "gather_conv_dfeats_cuda", "dw": "gather_conv_dw_cuda"}
    symbols = {"dfeats": ("ConvDFeats", "dfeats_kernel"),
               "dw": ("gather_dw_", "dw_kernel")}
    wrappers = {part: getattr(sc, name) for part, name in names.items()}
    backward = vars(sc.GatherConv)["backward"]
    groups, made = {}, {}

    def recorder(part):
        def call(*args, **kw):
            made[part] = (args, kw)
            return wrappers[part](*args, **kw)
        return call

    def keeping(ctx, g):
        made.clear()
        out = backward.__func__(ctx, g)
        feats, idx, w, valid = ctx.saved_tensors[:4]
        key = (_book_kind(idx.shape[0], feats.shape[0], idx.shape[1]),
               idx.shape[0], feats.shape[0], idx.shape[1], w.shape[1],
               w.shape[2], str(feats.dtype).split(".")[-1])
        entry = groups.setdefault(key, {"inputs": (feats, idx, w, valid, g),
                                        "calls": {}, "launches": {}})
        for part, call in made.items():
            entry["calls"].setdefault(part, call)
            entry["launches"][part] = entry["launches"].get(part, 0) + 1
        return out

    for part, name in names.items():
        setattr(sc, name, recorder(part))
    sc.GatherConv.backward = staticmethod(keeping)
    try:
        step()
    finally:
        sc.GatherConv.backward = backward
        for part, name in names.items():
            setattr(sc, name, wrappers[part])
    rows = []
    sums = {part: {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0,
                   "launches": 0} for part in names}
    with torch.no_grad():
        for key, entry in groups.items():
            feats, idx, w, valid, g = entry["inputs"]
            wants = dict(zip(("dfeats", "dw"), sc.gather_conv_backward(
                feats, idx, w, valid, g)))
            plain = time_ms(lambda: sc.gather_conv_backward(
                feats, idx, w, valid, g), 2)
            bounds, nnz = bwd_bound(feats, idx, w, valid)
            for part, (args, kw) in entry["calls"].items():
                fn = wrappers[part]
                got = fn(*args, **kw)
                same = torch.equal(_bits(got), _bits(fn(*args, **kw)))
                want = wants[part].float()
                err = float((got.float() - want).abs().max())
                tol = ((1e-4 if feats.dtype == torch.float32 else 1e-2)
                       * max(float(want.abs().max()), 1e-30))
                check(err <= tol, f"kernel A' {part} at training shape "
                      f"{key}: max abs err {err} > {tol}")
                ms = time_ms(lambda: fn(*args, **kw))
                dev_ms = device_ms(lambda: fn(*args, **kw), symbols[part])
                n = entry["launches"][part]
                b_ms, b_by = bounds[part]
                line = {"part": part, "kind": key[0], "K": key[1],
                        "V_in": key[2], "V_out": key[3], "Cin": key[4],
                        "Cout": key[5], "dtype": key[6], "launches": n,
                        "nnz": nnz, "max_abs_err": err, "tolerance": tol,
                        "same_bits_twice": same, "ms": ms,
                        "device_ms": dev_ms,
                        "plain_ms": plain, "plain_computes": "both parts",
                        "bound_ms": b_ms, "bound_by": b_by}
                print("kernel A' training shape", json.dumps(line))
                rows.append(line)
                sums[part]["ms"] += n * ms
                sums[part]["device_ms"] += n * (dev_ms or 0.0)
                sums[part]["bound_ms"] += n * b_ms
                sums[part]["launches"] += n
    summary = {"shapes": len(groups),
               "same_bits_twice": all(r["same_bits_twice"] for r in rows),
               **{f"{part}_sum_ms_per_step": v["ms"]
                  for part, v in sums.items()},
               **{f"{part}_sum_device_ms_per_step": v["device_ms"]
                  for part, v in sums.items()},
               **{f"{part}_sum_bound_ms_per_step": v["bound_ms"]
                  for part, v in sums.items()},
               **{f"{part}_launches_per_step": v["launches"]
                  for part, v in sums.items()}}
    print("kernel A' per training step:", json.dumps(summary))
    return rows, summary


def multi_match_queries(fine, coarse, kernel, stride):
    """The composite queries conv_rulebook_match and deconv_rulebook_match
    give kernel D for one downsample (fine -> coarse table), built as those
    functions build them: (conv queries, their valid count, deconv
    queries, their valid count)."""
    from detection_3d_tpu_torch.ops.coords import (
        INVALID, composite_key, pack_key)
    dev = fine.device
    st = torch.tensor([*stride, 1], dtype=torch.int32, device=dev)
    deltas = torch.tensor([[a, b, c, 0] for a in range(kernel[0])
                           for b in range(kernel[1])
                           for c in range(kernel[2])], dtype=torch.int32,
                          device=dev)
    qhi, qlo = pack_key((coarse.coords * st)[None] + deltas[:, None],
                        fine.spatial_size, valid=coarse.row_valid[None, :])
    num = fine.coords[None] - deltas[:, None]
    o = torch.div(num, st, rounding_mode="floor")
    dhi, dlo = pack_key(o, coarse.spatial_size,
                        valid=fine.row_valid[None, :]
                        & (o * st == num).all(-1))
    return (composite_key(qhi, qlo).reshape(-1), int((qhi != INVALID).sum()),
            composite_key(dhi, dlo).reshape(-1), int((dhi != INVALID).sum()))


def multi_match_sets(tables, cfg):
    """Kernel D's 17 query sets of a pyramid: (name, keys, queries, valid
    queries) for the conv and deconv book of every downsample, and the
    scale-0 conv queries shuffled (seed 0)."""
    s3d = cfg.sparse3d
    sets = []
    for k in range(1, s3d.num_scales):
        fine, coarse = tables[k - 1], tables[k]
        q, nq, qd, nqd = multi_match_queries(fine, coarse, s3d.kernels[k - 1],
                                             s3d.strides[k - 1])
        sets += [(f"conv {k}", fine.keys, q, nq),
                 (f"deconv {k}", coarse.keys, qd, nqd)]
        if k == 1:
            gen = torch.Generator(device=q.device).manual_seed(0)
            sets.append(("conv 1 shuffled", fine.keys, q[torch.randperm(
                q.numel(), generator=gen, device=q.device)], nq))
    return sets


def check_multi_match(tables, cfg, crb, drb):
    """Kernel D on the queries of every conv and deconv book of a
    full-size building's pyramid (16 launches through its own entry
    points), and on the scale-0 conv queries shuffled: each bit exact
    against multi_match_plain, the same bits on a second call, timed with
    the profiler's device time beside ``torch.searchsorted`` over the same
    composite queries (the library call: it computes the lower bound
    only, not the match), one ``kernel D shape`` line each and the sums
    per pyramid; the scale-0 conv and deconv books equal the
    scatter-derived ones. The scale-0 conv queries also give the CUDA
    event time and the plain version's. The bound counts the keys, the
    queries read and the answers written once, or ~4 operations for each
    of ceil(log2 V) + 1 probes per valid query. Returns the scale-0 conv
    line and the sums. Uses only the public forms of the package, so the
    phase times another tree of it too (``--compare``)."""
    from detection_3d_tpu_torch.ops.multi_match import (
        conv_rulebook_match, deconv_rulebook_match, multi_match_cuda,
        multi_match_plain)
    s3d = cfg.sparse3d
    k0, st0 = s3d.kernels[0], s3d.strides[0]
    check(torch.equal(conv_rulebook_match(tables[1], tables[0], k0, st0),
                      crb), "kernel D: conv book differs from the "
          "scatter-derived book")
    check(torch.equal(deconv_rulebook_match(tables[0], tables[1], k0, st0),
                      drb), "kernel D: deconv book differs from the "
          "scatter-derived book")
    sets = multi_match_sets(tables, cfg)
    sums = {"device_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    lines = {}
    for name, keys, qs, searches in sets:
        got = multi_match_cuda(keys, qs)
        check(torch.equal(got, multi_match_plain(keys, qs)),
              f"kernel D differs from multi_match_plain ({name})")
        check(torch.equal(got, multi_match_cuda(keys, qs)),
              f"kernel D: two calls differ ({name})")
        v, n = keys.numel(), qs.numel()
        probes = max(1, (v - 1).bit_length()) + 1
        b_ms, b_by = bound(v * 8 + n * 8 + n * 4, 4.0 * probes * searches,
                           SCALAR_OPS)
        line = {"book": name, "V": v, "queries": n, "searches": searches,
                "found": int((got < v).sum()), "max_abs_err": 0.0,
                "tolerance": "bit exact",
                "device_ms": device_ms(lambda: multi_match_cuda(keys, qs),
                                       ("multi_match",)),
                "library_ms": time_ms(lambda: torch.searchsorted(keys, qs)),
                "bound_ms": b_ms, "bound_by": b_by}
        if name == "conv 1":
            line["ms"] = time_ms(lambda: multi_match_cuda(keys, qs))
            line["plain_ms"] = time_ms(lambda: multi_match_plain(keys, qs), 3)
        print("kernel D shape", json.dumps(line))
        lines[name] = line
        if "shuffled" not in name:
            for key in sums:
                sums[key] += line[key] or 0.0
    summary = {"launches_per_pyramid": len(sets) - 1,
               **{f"sum_{k}_per_pyramid": v for k, v in sums.items()}}
    print("kernel D per pyramid:", json.dumps(summary))
    return lines["conv 1"], summary


def subm_windows(table, window):
    """Kernel B's shared-memory windows on one table, as csrc/
    subm_match.cu finds them: per block of 256 sites holding an active
    one and per dx, the rows from its smallest target to its largest.
    Returns how many there are, how many exceed ``window`` rows (searched
    in global memory), and their largest and mean length."""
    num = int(table.num)
    keys, Z = table.keys, table.spatial_size[2]
    first = torch.arange(0, num, 256, device=keys.device)
    last = torch.clamp(first + 255, max=num - 1)
    rows = torch.stack([
        torch.searchsorted(keys, keys[last] + (dx << 32) + Z + 2)
        - torch.searchsorted(keys, keys[first] + (dx << 32) - Z - 1)
        for dx in (-1, 0, 1)])
    return {"windows": rows.numel(),
            "over_budget": int((rows > window).sum()),
            "max_rows": int(rows.max()),
            "mean_rows": float(rows.float().mean())}


def subm_match_shapes(tables):
    """Kernel B at each table size of a full-size building (one launch per
    scale per building): the book bit exact against neighbor_indices and
    the row masks against row_masks, the same bits on a second call, both
    forms of the kernel (shared-memory windows, whole-table search) held
    and timed, the windows (:func:`subm_windows`), timed with CUDA events
    and the profiler's device time beside the plain neighbor_match_columns
    and ``torch.searchsorted`` over the 27 * V composite queries that
    neighbor_indices searches (the library call: the lower bound only).
    The bound counts the keys, coords and num read and the book and masks
    written once, or ~4 operations for each of ceil(log2 V) + 1 probes of
    a search per valid site and in-grid offset. Returns (the scale-0 line,
    the per-building summary)."""
    from detection_3d_tpu_torch.ops import sparse
    from detection_3d_tpu_torch.ops.coords import composite_key, pack_key
    from detection_3d_tpu_torch.ops.sparse_conv import row_masks
    offs = sparse.submanifold_offsets((3, 3, 3))
    deltas = torch.tensor([[a, b, c, 0] for a, b, c in offs],
                          dtype=torch.int32, device=tables[0].device)
    rows, sums = [], {"ms": 0.0, "device_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0}
    for t in tables:
        v, num = t.capacity, int(t.num)
        got, masks = sparse.neighbor_match_3x3x3(t)
        want = sparse.neighbor_indices(t, offs)
        check(torch.equal(got, want), f"kernel B differs from "
              f"neighbor_indices at V = {v}")
        check(torch.equal(masks, row_masks(want, v, t.row_valid)),
              f"kernel B: row masks differ from row_masks at V = {v}")
        again, masks_again = sparse.neighbor_match_3x3x3(t)
        check(torch.equal(again, got) and torch.equal(masks_again, masks),
              f"kernel B: two calls differ at V = {v}")
        line = {"V": v, "num": num, "masks": "equal to row_masks",
                "windows": subm_windows(t, sparse.SUBM_WINDOW)}
        line["ms"] = time_ms(lambda: sparse.neighbor_match_3x3x3(t))
        line["device_ms"] = device_ms(
            lambda: sparse.neighbor_match_3x3x3(t), ("subm_match_",))
        # both of the kernel's forms, whichever the wrapper takes
        for form, window in (("windows", sparse.SUBM_WINDOW), ("table", 0)):
            idx, m = sparse.subm_match_cuda(t, window)
            check(torch.equal(idx, want) and torch.equal(m, masks),
                  f"kernel B ({form}) differs at V = {v}")
            line[f"device_ms_{form}"] = device_ms(
                lambda: sparse.subm_match_cuda(t, window), ("subm_match_",))
        line["plain_ms"] = time_ms(lambda: sparse.neighbor_match_columns(t), 2)
        line["neighbor_indices_ms"] = time_ms(
            lambda: sparse.neighbor_indices(t, offs), 2)
        q = composite_key(*pack_key(t.coords[None] + deltas[:, None],
                                    t.spatial_size,
                                    t.row_valid[None, :])).reshape(-1)
        line["library_ms"] = time_ms(lambda: torch.searchsorted(t.keys, q))
        c = t.coords[:num, :3]
        size = torch.tensor(t.spatial_size, device=c.device)
        searches = sum(int(((c + d[:3] >= 0) & (c + d[:3] < size))
                           .all(1).sum()) for d in deltas)
        probes = max(1, (v - 1).bit_length()) + 1
        nbytes = v * 8 + v * 16 + 4 + 27 * v * 4 + v * 8
        line["bound_ms"], line["bound_by"] = bound(
            nbytes, 4.0 * probes * searches, SCALAR_OPS)
        line.update(searches=searches, found=int((got[:, :num] < v).sum()),
                    max_abs_err=0.0, tolerance="bit exact", launches=1)
        print("kernel B shape", json.dumps(line))
        rows.append(line)
        for key in sums:
            sums[key] += line[key] or 0.0
    summary = {"shapes": len(rows), "launches_per_building": len(rows),
               **{f"sum_{k}_per_building": v for k, v in sums.items()}}
    print("kernel B per building:", json.dumps(summary))
    return rows[0], summary


def build_pyramid_checked(cfg, table0):
    """build_pyramid of one building, serving and training forms, with
    ops/sparse_conv.row_masks wrapped to record the books it is given:
    no submanifold book may reach it (their row orders come from kernel
    B's masks), and each submanifold row order must equal
    rulebook_row_order of its book. Returns the serving pyramid."""
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.ops import sparse_conv as sc
    seen = []
    orig = sc.row_masks

    def recorder(neighbor_idx, *args, **kw):
        seen.append(neighbor_idx.data_ptr())
        return orig(neighbor_idx, *args, **kw)

    pyrs, others = [], 0
    sc.row_masks = recorder
    try:
        for backward in (False, True):
            seen.clear()
            pyr = build_pyramid(table0, cfg, backward=backward)
            subm = {b.idx.data_ptr() for b in pyr["subm"]}
            check(not subm & set(seen), "build_pyramid computed row_masks "
                  "of a submanifold book")
            others += len(seen)
            pyrs.append(pyr)
    finally:
        sc.row_masks = orig
    for pyr in pyrs:
        for t, b in zip(pyr["tables"], pyr["subm"]):
            want = sc.rulebook_row_order(b.idx, t.capacity, t.row_valid)
            check(torch.equal(b.order.perm, want.perm)
                  and torch.equal(b.order.masks, want.masks),
                  "build_pyramid: a submanifold row order differs from "
                  "rulebook_row_order of its book")
    print(f"build_pyramid: {len(pyrs[0]['subm'])} submanifold row orders "
          f"from kernel B's masks equal rulebook_row_order of their books "
          f"(serving and training pyramids); row_masks ran on "
          f"{others} other books, on no submanifold book")
    return pyrs[0]


def _nms_boxes_np(n, seed):
    """(n, 7) yx_zb boxes like decoded proposals: clusters of near
    duplicates, exact duplicates and thin walls over a 40 m building."""
    rng = np.random.RandomState(seed)
    m = n // 4
    base = np.c_[rng.uniform(0, 40, (m, 2)), rng.uniform(0, 2, (m, 1)),
                 rng.uniform(0.1, 3.0, (m, 2)), rng.uniform(0.2, 3.0, (m, 1)),
                 rng.uniform(-1.57, 1.57, (m, 1))]
    boxes = np.repeat(base, 4, axis=0)
    boxes[:, :2] += rng.normal(0, 0.05, (n, 2))
    boxes[:, 6] += rng.normal(0, 0.05, n)
    boxes[::7, 4] = 0.095
    boxes[1::50] = boxes[0::50]
    return boxes.astype(np.float32)


def _bit_mismatches(got, want):
    """Entries whose float32 bits differ (two NaNs count as equal)."""
    diff = got.view(torch.int32) != want.view(torch.int32)
    return int((diff & ~(torch.isnan(got) & torch.isnan(want))).sum())


def _max_abs_err(got, want):
    fin = torch.isfinite(got) & torch.isfinite(want)
    return float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) \
        else 0.0


def _hold_c(name, got, want):
    bad = _bit_mismatches(got, want)
    check(bad == 0, f"kernel C {name}: {bad} entries differ in their bits "
          "from rotated_iou_plain")
    return _max_abs_err(got, want)


def check_rotated_iou(dev):
    """Kernel C against rotated_iou_plain, bit for bit: on the adversarial
    set (all pairs, criteria -1/0/1/2 and the raw intersection, with and
    without the same-box fix) and at 2000 x 2000 NMS-like boxes for
    criteria -1/0/1/2; greedy NMS keep sets of both matrices equal. The
    NMS call (criterion -1, same-box fix) is timed."""
    from detection_3d_tpu_torch.ops.nms import greedy_plain
    from detection_3d_tpu_torch.ops.rotated_iou import (
        iou_may_meet, rotated_iou_cuda, rotated_iou_plain, z_interval_iou)
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_iou_cases import adversarial_bev      # shared with the tests
    adv = torch.from_numpy(adversarial_bev()).to(dev)
    errs = {}
    for crit in (-1, 0, 1, 2, 3):
        for fix in (False, True):
            errs[f"adversarial {crit} {fix}"] = _hold_c(
                f"adversarial set, criterion {crit}, same_box_fix {fix}",
                rotated_iou_cuda(adv, adv, crit, fix),
                rotated_iou_plain(adv, adv, crit, fix))
    meet = iou_may_meet(adv, adv)
    inter = rotated_iou_plain(adv, adv, 3)
    check(not bool(((inter > 0) & ~meet).any()), "iou_may_meet rules out a "
          "pair of the adversarial set that meets")
    print(f"kernel C adversarial set: {adv.shape[0]}^2 pairs bit exact, "
          f"{int((~meet).sum())} ruled out by the cull")
    n = 2000
    boxes = torch.from_numpy(_nms_boxes_np(n, 0)).to(dev)
    bev = boxes[:, [0, 1, 3, 4, 6]].contiguous()
    for crit in (-1, 0, 1, 2):
        got = rotated_iou_cuda(bev, bev, crit, True)
        want = rotated_iou_plain(bev, bev, crit, True)
        errs[f"2000^2 {crit}"] = _hold_c(f"2000^2 criterion {crit}", got,
                                        want)
        if crit == -1:
            iouz = z_interval_iou(boxes[:, [2, 5]], boxes[:, [2, 5]])
            valid = torch.ones(n, dtype=torch.bool, device=dev)
            k_keep = greedy_plain((got * iouz)[None], valid[None], 0.5,
                                  1000)
            p_keep = greedy_plain((want * iouz)[None], valid[None], 0.5,
                                  1000)
            check(torch.equal(k_keep[0], p_keep[0]),
                  "kernel C: NMS keep sets differ from the plain version")
            t0 = time.perf_counter()
            greedy_plain((got * iouz)[None], valid[None], 0.5, 1000)
            greedy_ms = (time.perf_counter() - t0) * 1e3
            ms = time_ms(lambda: rotated_iou_cuda(bev, bev, crit, True))
            plain = time_ms(lambda: rotated_iou_plain(bev, bev, crit, True),
                            2)
            meeting = int((rotated_iou_plain(bev, bev, 3) > 0).sum())
            nbytes = 2 * n * 5 * 4 + n * n * 4
            b_ms, b_by = bound(nbytes, float(IOU_OPS_PER_PAIR) * meeting,
                               SCALAR_OPS)
            all_ms, _ = bound(nbytes, float(IOU_OPS_PER_PAIR) * n * n,
                              SCALAR_OPS)
            report = {"N": n, "K": n, "kept": int(k_keep[1][0]), "ms": ms,
                      "plain_ms": plain, "pairs_meeting": meeting,
                      "pairs_may_meet": int(iou_may_meet(bev, bev).sum()),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "bound_all_pairs_ms": all_ms,
                      "greedy_host_ms": greedy_ms}
    report["max_abs_err"] = max(errs.values())
    report["tolerance"] = "bit exact"
    report["max_abs_err_by_case"] = errs
    print("kernel C", json.dumps(report))
    return report


def capture_iou_calls(fn):
    """Runs ``fn`` with kernel C's wrapper wrapped to keep the inputs of
    each call: [(boxes, query, criterion, same_box_fix), ...]."""
    from detection_3d_tpu_torch.ops import rotated_iou as ri
    calls = []
    orig = ri.rotated_iou_cuda

    def recorder(boxes, query, criterion=-1, same_box_fix=False):
        calls.append((boxes, query, criterion, same_box_fix))
        return orig(boxes, query, criterion, same_box_fix)

    ri.rotated_iou_cuda = recorder
    try:
        fn()
    finally:
        ri.rotated_iou_cuda = orig
    return calls


def check_rotated_iou_training(calls, cols=4096):
    """Kernel C at the shapes a full-width training step calls it with,
    on the inputs that step gave it (:func:`capture_iou_calls`): RPN
    targets (max_gt gt boxes x every anchor, criterion 2), the RPN's NMS
    and ROI targets (max_gt gt boxes x decoded proposals and gt,
    criterion -1), with the pad rows parked as the targets park them.
    Each call is held bit for bit against the plain version on every
    pair, in chunks of ``cols`` query columns, and timed (its plain
    version too where it fits one chunk). The bound counts the
    operations of the pairs whose plain intersection is > 0 only (the
    kernel culls the others); the all-pairs bound stands beside it."""
    from detection_3d_tpu_torch.ops.rotated_iou import (
        PARK_QUERIES, PARK_TARGETS, iou_may_meet, rotated_iou_cuda,
        rotated_iou_plain)

    def parked(b, at):
        return int(((b[:, 0] == at[0]) & (b[:, 1] == at[1])).sum())

    line = {}
    for boxes, query, crit, fix in calls:
        if boxes.dim() == 3:     # the NMS, a batch of one building's
            check(boxes.shape[0] == 1, f"kernel C: a training step's NMS "
                  f"holds {boxes.shape[0]} matrices")
            boxes, query = boxes[0], query[0]
        n, k = boxes.shape[0], query.shape[0]
        name = ("rpn_targets" if crit == 2 else "nms" if n == k
                else "roi_targets")
        full = rotated_iou_cuda(boxes, query, crit, fix)
        err, meeting, may_meet, chunks = 0.0, 0, 0, 0
        for c0 in range(0, k, cols):
            q = query[c0:c0 + cols]
            err = max(err, _hold_c(
                f"criterion {crit} at the {name} shape, columns {c0}..",
                full[:, c0:c0 + cols].contiguous(),
                rotated_iou_plain(boxes, q, crit, fix)))
            meeting += int((rotated_iou_plain(boxes, q, 3) > 0).sum())
            may_meet += int(iou_may_meet(boxes, q).sum())
            chunks += 1
        ms = time_ms(lambda: rotated_iou_cuda(boxes, query, crit, fix))
        plain = (time_ms(lambda: rotated_iou_plain(boxes, query, crit, fix),
                         2) if k <= cols else None)
        nbytes = 5 * 4 * (n + k) + n * k * 4
        b_ms, b_by = bound(nbytes, float(IOU_OPS_PER_PAIR) * meeting,
                           SCALAR_OPS)
        all_ms, _ = bound(nbytes, float(IOU_OPS_PER_PAIR) * n * k,
                          SCALAR_OPS)
        line[name] = {"N": n, "K": k, "criterion": crit,
                      "same_box_fix": bool(fix),
                      "parked_targets": parked(boxes, PARK_TARGETS),
                      "parked_queries": parked(query, PARK_QUERIES),
                      "max_abs_err": err, "column_chunks": chunks,
                      "pairs": n * k, "pairs_may_meet": may_meet,
                      "pairs_meeting": meeting, "ms": ms, "plain_ms": plain,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "bound_all_pairs_ms": all_ms}
    check("rpn_targets" in line and "roi_targets" in line,
          f"kernel C: the training step made the calls {sorted(line)}")
    line["tolerance"] = "bit exact"
    print("kernel C (training shapes)", json.dumps(line))
    return line


def _profile(fn):
    """utils/profiling.device_activity over one call of ``fn`` on the card:
    the device's busy time (the union of the activities over every
    stream) beside their sum, the span from the first to the last device
    activity, the idle share, per-kernel and top device times (ms). Raises
    when the profiler records no device activity."""
    from detection_3d_tpu_torch.utils.profiling import device_activity
    return device_activity(fn)


def _brief(prof, keys=None):
    """A profile without its by-name table, or only ``keys`` of it."""
    return {k: v for k, v in prof.items()
            if (k in keys if keys else k != "by_name_ms")}


def device_profile(predict, batch):
    """:func:`_profile` over one building of the serving path."""
    def run():
        with torch.inference_mode():
            out, _ = predict(batch)
            out.cpu()
    return _profile(run)


def stage_spans(predict, batch):
    """The span log of one predict of ``batch`` under torch.profiler
    (utils/profiling.span): {name: [host seconds, host syncs]} of
    ``model.predict`` and every ``model.*`` span inside it, summed by
    name; the syncs are each span's own (not those of the spans inside
    it). The forward is not synchronised, so a stage's time is its
    launches and its waits at host syncs."""
    from torch.profiler import ProfilerActivity, profile
    from detection_3d_tpu_torch.utils.profiling import recorded_spans
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    recorded_spans()
    with torch.inference_mode(), profile(activities=acts):
        out, _ = predict(batch)
        out.cpu()
    stages = {}
    for r in recorded_spans():
        if r.name.startswith("model."):
            sec, syncs = stages.get(r.name, (0.0, 0))
            stages[r.name] = [sec + r.seconds, syncs + r.syncs]
    check("model.backbone" in stages, "the span log holds no "
          f"model.backbone span: {sorted(stages)}")
    return stages


def valid_rows(packed):
    a = packed.cpu().numpy()
    a = a[a[:, 9] > 0.5]
    return a[np.lexsort((a[:, 7], a[:, 8]))]


def train_path(cfg, scenes, dev):
    """The training path at full width: a Trainer on the card takes
    TRAIN_STEPS steps (one epoch over TRAIN_STEPS buildings), with launch
    counts set to 0 just before and read just after. Then one more step
    under the profiler, one through
    :func:`gather_conv_bwd_training_shapes` and one that keeps its kernel
    C inputs. Returns (launches, report, the A′ summary, the kept kernel
    C calls)."""
    import shutil
    from detection_3d_tpu_torch.engine.trainer import Trainer, pad_scene
    from detection_3d_tpu_torch.ops import cuda_lib
    out_dir = cuda_lib.BUILD_DIR / "train_smoke"    # gitignored, removed
    trainer = Trainer(cfg, output_dir=str(out_dir), device=dev)
    state = trainer.init_state(seed=0)
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    state = trainer.train(scenes[:TRAIN_STEPS], state, epochs=1, seed=0)
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
                 "subm_match", "rotated_iou"):
        check(launches[name] > 0, f"kernel {name} was not launched on the "
              "training path")
    for i, (total, losses, ok, _) in enumerate(trainer.history):
        check(np.isfinite(total) and all(np.isfinite(v)
                                         for v in losses.values()),
              f"training step {i}: non-finite loss {losses}")
    check(len(trainer.history) == TRAIN_STEPS, "training: steps missing")
    check(state.solver.count >= 1, "training: no step was applied")
    moved = sum(int(not torch.equal(p.detach(), b))
                for p, b in zip(state.model.parameters(), before))
    check(moved > 0, "training: the parameters did not change")
    secs = [h[3] for h in trainer.history]
    sec = sum(secs[1:]) / max(len(secs) - 1, 1)
    pad_secs = []               # padding alone, part of each step's span
    for sc in scenes[:TRAIN_STEPS]:
        t1 = time.perf_counter()
        pad_scene(cfg, sc)
        pad_secs.append(time.perf_counter() - t1)
    pad_s = float(np.median(pad_secs))
    report = {"steps": len(secs), "applied": state.solver.count,
              "s_per_step": sec, "step_seconds": secs, "wall_s": wall,
              "pad_scene_median_s": pad_s,
              "peak_device_memory_gib": peak_gb,
              "parameters_moved": moved,
              "parameters": len(before),
              "losses": [h[1] for h in trainer.history]}
    print("training path:", json.dumps(report))
    print(f"training path: {sec:.4f} s/step over steps 2..{len(secs)} "
          f"(host clock, synchronised: scene fetched and padded -> losses "
          f"on the host, backward and update included; padding alone "
          f"{pad_s:.4f} s median), peak device memory "
          f"{peak_gb:.2f} GiB, launches {json.dumps(launches)}")
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = pad_scene(cfg, scenes[-1])
    prof = _profile(lambda: trainer.step(state, batch, gen))
    print("device profile of one more training step: "
          + json.dumps(_brief(prof)))
    _, bwd = gather_conv_bwd_training_shapes(
        lambda: trainer.step(state, batch, gen))
    check(bwd["same_bits_twice"], "kernel A': two calls at a training "
          "shape gave different bits")
    iou_calls = capture_iou_calls(lambda: trainer.step(state, batch, gen))
    del trainer, state, before
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches, report, bwd, iou_calls


def pyramid_seconds(cfg, scene, dev, rounds=6):
    """Host clock (synchronised) of build_pyramid on one full-size
    building without and with the backward books, alternating over
    ``rounds`` rounds after a warm-up of each: what a training forward
    pays for the books. The host clock of this machine varies by run, so
    the minimum and the median of each stand beside the list."""
    from detection_3d_tpu_torch.engine.trainer import (
        batch_to_device, pad_scene)
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.models.detector import voxelize_points
    with torch.no_grad():
        (pts, fts, valid), _, _ = batch_to_device(pad_scene(cfg, scene), dev)
        table = voxelize_points(cfg, pts, fts, valid)
        out = {False: [], True: []}
        for i in range(2 * rounds + 2):
            backward = bool(i % 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build_pyramid(table, cfg, backward=backward)
            torch.cuda.synchronize()
            if i >= 2:
                out[backward].append(time.perf_counter() - t0)
    line = {}
    for backward, key in ((False, "without_books"), (True, "with_books")):
        secs = sorted(out[backward])
        line[key] = {"min_s": secs[0], "median_s": float(np.median(secs)),
                     "seconds": out[backward]}
    print("pyramid of one building:", json.dumps(line))
    return line


def match_path(cfg, scene, dev):
    """Kernel D's own entry points, as a caller would use them: the conv
    and deconv books of every downsample of a full-size building's
    pyramid, counts set to 0 just before and read just after; each book
    must equal the pyramid's scatter-derived one."""
    from detection_3d_tpu_torch.engine.trainer import (
        batch_to_device, pad_scene)
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.models.detector import voxelize_points
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.ops.multi_match import (
        conv_rulebook_match, deconv_rulebook_match)
    s3d = cfg.sparse3d
    with torch.inference_mode():
        (pts, fts, valid), _, _ = batch_to_device(pad_scene(cfg, scene), dev)
        pyr = build_pyramid(voxelize_points(cfg, pts, fts, valid), cfg)
        tables = pyr["tables"]
        cuda_lib.reset_launches()
        books = [(conv_rulebook_match(tables[k], tables[k - 1],
                                      s3d.kernels[k - 1], s3d.strides[k - 1]),
                  deconv_rulebook_match(tables[k - 1], tables[k],
                                        s3d.kernels[k - 1],
                                        s3d.strides[k - 1]))
                 for k in range(1, s3d.num_scales)]
        torch.cuda.synchronize()
        launches = dict(cuda_lib.launches)
        for k, (c, d) in enumerate(books):
            check(torch.equal(c, pyr["down"][k].idx),
                  f"kernel D path: conv book {k} differs")
            check(torch.equal(d, pyr["up"][k].idx),
                  f"kernel D path: deconv book {k} differs")
    check(launches["multi_match"] == 2 * (s3d.num_scales - 1),
          "kernel D path: launch count")
    print(f"kernel D path: {len(books)} conv + {len(books)} deconv books of "
          f"one full-size pyramid equal the scatter-derived books, "
          f"launches {json.dumps(launches)}")
    return launches


HOUSES = 2               # train houses and test houses of the eval phase


def write_houses(root, cfg, buildings):
    """Reference-format SUNCG houses under ``root`` (data/suncg.py): the
    first half of ``buildings`` as the train split, the rest as the test
    split; each house one ``.pth`` of (pcl (N, 9) xyz in metres + colour
    + normal, {class: (M, 7) standard boxes}), its boxes turned back
    through ops/geometry.yx_zb_to_standard."""
    from detection_3d_tpu_torch.ops.geometry import yx_zb_to_standard
    names = cfg.ordered_class_names()
    scale = cfg.sparse3d.voxel_scale
    splits = {"train": [], "test": []}
    for i, b in enumerate(buildings):
        scene = f"house_{i}"
        splits["train" if i < len(buildings) // 2 else "test"].append(scene)
        pcl = np.c_[b["points"] / scale, b["feats"][:, 3:9]].astype(
            np.float32)
        std = yx_zb_to_standard(torch.from_numpy(b["gt_boxes"])).numpy()
        boxes = {names[lab]: std[b["gt_labels"] == lab]
                 for lab in range(1, len(names))}
        (root / "houses" / scene).mkdir(parents=True)
        torch.save((pcl, boxes), root / "houses" / scene / "0.pth")
    (root / "train_test_splited").mkdir()
    for split, scenes in splits.items():
        (root / "train_test_splited" / f"{split}.txt").write_text(
            "\n".join(scenes) + "\n")


def _corner_gap(a, b):
    """Per row, the largest distance from a BEV corner of yx_zb box ``a``
    to the nearest corner of box ``b``: 0 for the same footprint written
    at another quarter turn with its sizes swapped."""
    from detection_3d_tpu_torch.ops.geometry import rbbox_corners_2d
    ca, cb = (rbbox_corners_2d(torch.from_numpy(x[:, [0, 1, 3, 4, 6]]).to(
        torch.float64)) for x in (a, b))
    d = torch.cdist(ca, cb)                        # (M, 4, 4)
    return d.min(2).values.max(1).values.numpy()


def check_read_back(scene, building, cfg, tol_voxels=1e-2):
    """A house read through SUNCGDataset against the building it was
    written from: every point and every gt box (centre, z size, BEV
    footprint) equal within ``tol_voxels`` voxels once the shift that
    prepare_scene applies is taken out; equal labels. Returns the shift
    (voxels) and the largest error (voxels)."""
    scale = cfg.sparse3d.voxel_scale
    src, got = building["points"], scene["points"]
    check(got.shape == src.shape, f"read-back: {got.shape[0]} points of "
          f"{src.shape[0]}")
    shift = (got - src).mean(0)
    err = float(np.abs(got - src - shift).max())
    order = np.argsort(building["gt_labels"], kind="stable")
    want_b, want_l = building["gt_boxes"][order], building["gt_labels"][order]
    check(np.array_equal(scene["gt_labels"], want_l), "read-back: labels")
    gb = scene["gt_boxes"].astype(np.float64)
    moved = want_b.astype(np.float64)
    moved[:, :3] += shift / scale
    err = max(err,
              float(np.abs(gb[:, :3] - moved[:, :3]).max()) * scale,
              float(np.abs(gb[:, 5] - moved[:, 5]).max()) * scale,
              float(_corner_gap(gb, moved).max()) * scale)
    check(err <= tol_voxels, f"read-back: {err} voxels off (tolerance "
          f"{tol_voxels})")
    return float(np.abs(shift).max()), err


class EvalRecorder:
    """Wraps evaluate_detections where ``modules`` call it: each call runs
    with the launch counts set to 0 just before it and read just after
    (the counts of the path around it are kept and added back), its host
    seconds timed, and the (building, class) pairs that hold both
    detections and gts counted from its inputs."""

    def __init__(self, *modules):
        from detection_3d_tpu_torch.evaluation import detection_eval
        self.modules, self.calls = modules, []
        self.orig = detection_eval.evaluate_detections

    def __enter__(self):
        for m in self.modules:
            m.evaluate_detections = self
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.evaluate_detections = self.orig

    def __call__(self, predictions, groundtruths, num_classes, *args, **kw):
        from detection_3d_tpu_torch.ops import cuda_lib
        outer = dict(cuda_lib.launches)
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        result = self.orig(predictions, groundtruths, num_classes, *args,
                           **kw)
        sec = time.perf_counter() - t0
        launches = dict(cuda_lib.launches)
        for k, v in outer.items():
            cuda_lib.launches[k] = v + launches[k]
        pairs = sum(int((p["labels"] == lab).any() and
                        (g["labels"] == lab).any())
                    for p, g in zip(predictions, groundtruths)
                    for lab in range(1, num_classes))
        self.calls.append({"buildings": len(predictions), "seconds": sec,
                           "s_per_building": sec / max(len(predictions), 1),
                           "pairs_with_both": pairs, "launches": launches,
                           "inputs": (predictions, groundtruths,
                                      num_classes, args, kw),
                           "result": result})
        return result


def _eval_fields_equal(got, want, tol=1e-6):
    """AP, AIoU, missed_rate and multi_rate per class within ``tol``, NaN
    in the same places. Returns the largest difference."""
    worst = 0.0
    for field in ("ap", "aiou", "missed_rate", "multi_rate"):
        a, b = getattr(got, field), getattr(want, field)
        check(np.array_equal(np.isnan(a), np.isnan(b)),
              f"evaluation card vs CPU: NaNs of {field} differ: {a} vs {b}")
        fin = ~np.isnan(b)
        d = float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0
        check(d <= tol, f"evaluation card vs CPU: {field} differs by {d}: "
              f"{a} vs {b}")
        worst = max(worst, d)
    return worst


def check_rotated_iou_eval(calls):
    """Kernel C at the evaluator's shapes (one (gts of a class) x
    (detections of the class) matrix per building and class, criterion
    -1, the same-box fix), on the inputs the evaluation gave it
    (:func:`capture_iou_calls`): held bit for bit against the plain
    version and timed, with its bound from the pairs that meet."""
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.ops.rotated_iou import (
        rotated_iou_cuda, rotated_iou_plain)
    rows, err = [], 0.0
    for boxes, query, crit, fix in calls:
        n, k = boxes.shape[0], query.shape[0]
        err = max(err, _hold_c(f"evaluator shape {n} x {k}",
                               rotated_iou_cuda(boxes, query, crit, fix),
                               rotated_iou_plain(boxes, query, crit, fix)))
        meeting = int((rotated_iou_plain(boxes, query, 3) > 0).sum())
        b_ms, b_by = bound(5 * 4 * (n + k) + n * k * 4,
                           float(IOU_OPS_PER_PAIR) * meeting, SCALAR_OPS)
        rows.append({"N": n, "K": k, "pairs_meeting": meeting,
                     "ms": time_ms(lambda: rotated_iou_cuda(boxes, query,
                                                            crit, fix)),
                     "plain_ms": time_ms(lambda: rotated_iou_plain(
                         boxes, query, crit, fix), 2),
                     "bound_ms": b_ms, "bound_by": b_by})
    line = {"calls": rows, "max_abs_err": err, "tolerance": "bit exact"}
    for key in ("ms", "plain_ms", "bound_ms"):
        line[f"sum_{key}"] = sum(r[key] for r in rows)
    line["sum_device_ms"] = device_ms(
        lambda: [rotated_iou_cuda(*c) for c in calls],
        [cuda_lib.SYMBOLS["rotated_iou"]])
    print("kernel C (evaluator shapes)", json.dumps(line))
    return line


def train_eval_path(cfg, buildings, dev, train_s_per_step):
    """The train-and-evaluate entry point at full width and full depth
    (tools/train_net.train_and_evaluate, as the CLI runs it after reading
    its YAML): HOUSES train and HOUSES test houses written in the
    reference format and read back through SUNCGDataset, one epoch with
    eval_in_train=1 and a checkpoint, the served test houses evaluated
    (kernel C once per (building, class) pair with both detections and
    gts), the same predictions evaluated again on the CPU, and a second
    call with only_test that resumes from the tag. Launch counts are set
    to 0 just before each call and read just after; each evaluation's
    own counts likewise. Everything written is removed. Returns (the
    launches of the first call's two evaluations, kernel C at the
    evaluator's shapes)."""
    import dataclasses
    import shutil
    from detection_3d_tpu_torch.data.suncg import SUNCGDataset
    from detection_3d_tpu_torch.engine import inference, trainer as tr
    from detection_3d_tpu_torch.evaluation.detection_eval import (
        evaluate_detections)
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.tools.train_net import train_and_evaluate
    root = cuda_lib.BUILD_DIR / "train_eval_smoke"   # gitignored, removed
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        write_houses(root / "data", cfg, buildings)
        train = SUNCGDataset("train", cfg, str(root / "data"))
        test = SUNCGDataset("test", cfg, str(root / "data"))
        check(len(train) == len(test) == len(buildings) // 2,
              f"read-back: {len(train)} train and {len(test)} test houses")
        train_scenes = [train[i] for i in range(len(train))]
        test_scenes = [test[i] for i in range(len(test))]
        read = [check_read_back(s, b, cfg)
                for s, b in zip(train_scenes + test_scenes, buildings)]
        print(f"houses: {len(buildings)} written and read back through "
              f"SUNCGDataset in {time.perf_counter() - t0:.1f} s; points "
              f"and gt boxes equal the buildings within "
              f"{max(e for _, e in read):.2e} voxels after a shift of at "
              f"most {max(s for s, _ in read):.2e} voxels; labels equal")

        run_cfg = cfg.replace(
            eval_in_train=1, output_dir=str(root / "out"),
            solver=dataclasses.replace(cfg.solver, epochs=1,
                                       epochs_between_test=1,
                                       checkpoint_period_epochs=1))
        cuda_lib.reset_launches()
        with EvalRecorder(inference, tr) as rec:
            t0 = time.perf_counter()
            trainer, state, preds, result = train_and_evaluate(
                run_cfg, train_scenes, test_scenes, device=dev)
            wall = time.perf_counter() - t0
        launches = dict(cuda_lib.launches)
        for i, (total, losses, ok, _) in enumerate(trainer.history):
            check(np.isfinite(total) and all(np.isfinite(v)
                                             for v in losses.values()),
                  f"eval-in-train step {i}: non-finite loss {losses}")
        check(len(trainer.history) == len(train_scenes),
              "eval-in-train: steps missing")
        check(trainer.last_train_eval is not None,
              "eval-in-train: no last_train_eval")
        n = cfg.num_classes
        for what, res, scenes in (("eval-in-train", trainer.last_train_eval,
                                   train_scenes),
                                  ("served test houses", result,
                                   test_scenes)):
            want = np.bincount(np.concatenate(
                [s["gt_labels"] for s in scenes]), minlength=n)
            want[0] = 0
            check(np.array_equal(res.n_gt, want), f"{what}: n_gt "
                  f"{res.n_gt.tolist()} != the houses' {want.tolist()}")
        check(len(rec.calls) == 2, f"{len(rec.calls)} evaluations, not 2")
        for name, call in zip(("eval_in_train", "serving"), rec.calls):
            check(call["launches"]["rotated_iou"] == call["pairs_with_both"],
                  f"{name} evaluation: kernel C launched "
                  f"{call['launches']['rotated_iou']} times for "
                  f"{call['pairs_with_both']} (building, class) pairs with "
                  "both detections and gts")
            check(sum(call["launches"].values())
                  == call["launches"]["rotated_iou"],
                  f"{name} evaluation launched {call['launches']}")
        for p in preds:
            check(p["boxes"].shape[0] > 0 and np.isfinite(
                p["boxes"]).all() and np.isfinite(p["scores"]).all(),
                "served test houses: no or non-finite detections")

        # the same predictions, the plain IoU on the CPU
        p_in, g_in, nc, args, kw = rec.calls[1]["inputs"]
        cpu = evaluate_detections(p_in, g_in, nc, *args,
                                  **dict(kw, device="cpu"))
        worst = _eval_fields_equal(result, cpu)
        iou_calls = capture_iou_calls(
            lambda: evaluate_detections(p_in, g_in, nc, *args, **kw))
        rep_c = check_rotated_iou_eval(iou_calls)

        step_s = [h[3] for h in trainer.history]
        params = [p.detach().clone() for p in state.model.parameters()]
        step = state.step
        del trainer, state
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        trainer2, state2, preds2, _ = train_and_evaluate(
            run_cfg, train_scenes, test_scenes, only_test=True, device=dev)
        wall2 = time.perf_counter() - t0
        check(state2.step == step and not trainer2.history,
              f"resume: step {state2.step}, expected {step} and no training")
        check(all(torch.equal(a.detach(), b) for a, b in
                  zip(state2.model.parameters(), params)),
              "resume: parameters differ from the first run's final ones")
        det_err = 0.0
        for a, b in zip(preds, preds2):
            ra, rb = (np.c_[x["boxes"], x["scores"], x["labels"]]
                      for x in (a, b))
            ra, rb = (r[np.lexsort((r[:, 7], r[:, 8]))] for r in (ra, rb))
            check(ra.shape == rb.shape and np.array_equal(ra[:, 8], rb[:, 8]),
                  f"resume: {rb.shape[0]} detections, first run {ra.shape[0]}")
            det_err = max(det_err, float(np.abs(ra - rb).max()))
        check(det_err <= 1e-4, f"resume: detections differ by {det_err}")
        del trainer2, state2

        evals = {name: {"buildings": c["buildings"], "seconds": c["seconds"],
                        "s_per_building": c["s_per_building"],
                        "pairs_with_both": c["pairs_with_both"],
                        "kernel_c_launches": c["launches"]["rotated_iou"]}
                 for name, c in zip(("eval_in_train", "serving"), rec.calls)}
        report = {
            "houses": {"train": len(train_scenes), "test": len(test_scenes)},
            "wall_s": wall, "resume_wall_s": wall2,
            "eval_in_train_step_seconds": step_s,
            "training_path_s_per_step": train_s_per_step,
            "evaluations": evals,
            "card_vs_cpu_max_diff": worst, "resume_max_abs_err": det_err,
            "launches": launches,
            "ap": [None if np.isnan(v) else float(v) for v in result.ap],
            "aiou": [None if np.isnan(v) else float(v) for v in result.aiou]}
        print("train-and-evaluate path:", json.dumps(report))
        for name, e in evals.items():
            print(f"evaluator ({name}): {e['s_per_building']:.4f} host "
                  f"s/building over {e['buildings']} buildings, kernel C "
                  f"launched {e['kernel_c_launches']} times (once per "
                  f"(building, class) pair with detections and gts)")
        print(f"eval-in-train steps: {json.dumps(step_s)} s (host clock; "
              f"the first warms up this trainer) beside the training "
              f"path's {train_s_per_step:.4f} s/step; card vs CPU "
              f"evaluation: AP, AIoU and rates within {worst:.2e}; resume: "
              f"parameters bit equal, detections within {det_err:.2e}")
        print(f"card: {card_line()}")
        eval_launches = {k: sum(c["launches"][k] for c in rec.calls)
                         for k in launches}
        return eval_launches, rep_c
    finally:
        shutil.rmtree(root, ignore_errors=True)


def tiny_predict_card_vs_cpu(tcfg, scene, card="cuda", what="small building"):
    """One small building through predict on the CPU (plain versions) and
    on the card (kernels), same weights: equal true_num, the valid rows
    the same set with equal labels, boxes and scores within 1e-4. Returns
    the card's valid rows."""
    from detection_3d_tpu_torch.engine.inference import (
        make_predict_fn, pad_scene)
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    tmodel = SparseRCNN(tcfg, seed=0)
    tb = pad_scene(tcfg, scene)
    cpu_out, cpu_tn = make_predict_fn(tcfg, tmodel, device="cpu")(tb)
    gpu_out, gpu_tn = make_predict_fn(tcfg, tmodel, device=card)(tb)
    want, got = valid_rows(cpu_out), valid_rows(gpu_out)
    check(int(cpu_tn) == int(gpu_tn), f"{what}: true_num differs")
    check(got.shape == want.shape and want.shape[0] > 0,
          f"{what}: {got.shape[0]} valid rows on the card, "
          f"{want.shape[0]} on the CPU")
    check(np.array_equal(got[:, 8], want[:, 8]), f"{what}: labels")
    err = float(np.abs(got[:, :8] - want[:, :8]).max())
    check(err <= 1e-4, f"{what}: max abs err {err}")
    print(f"{what}: {want.shape[0]} detections agree card vs CPU "
          f"(max abs err {err:.2e}, tolerance 1e-4)")
    return got


def tiny_train_card_vs_cpu(tcfg, scene, card="cuda",
                           what="tiny training step"):
    """One training step at the tiny config on the CPU (plain versions)
    and on the card (kernels), same weights and sampler draws. Losses
    within 1e-4; each gradient within 1e-3 of its largest entry + 1e-5
    (the card sums in other orders, through ~40 layers and batch
    norms). Returns the card's losses."""
    import copy
    from detection_3d_tpu_torch.engine.trainer import (
        batch_to_device, pad_scene, total_loss)
    from detection_3d_tpu_torch.models.detector import (
        SparseRCNN, voxelize_points)
    batch = pad_scene(tcfg, scene)
    base = SparseRCNN(tcfg, seed=0)
    g = torch.Generator().manual_seed(0)
    pri = {k: torch.rand((n,), generator=g)
           for k, n in base.priority_shapes().items()}
    res = {}
    for d in ("cpu", card):
        model = copy.deepcopy(base).to(d)
        (pts, fts, valid), gt, gtl = batch_to_device(batch, d)
        losses = model(voxelize_points(tcfg, pts, fts, valid), gt, gtl,
                       priorities={k: v.to(d) for k, v in pri.items()})
        total_loss(losses).backward()
        res[d] = ({k: float(v.detach()) for k, v in losses.items()},
                  {n: None if p.grad is None else p.grad.cpu()
                   for n, p in model.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = res["cpu"], res[card]
    loss_err = max(abs(l_cpu[k] - l_gpu[k]) for k in l_cpu)
    check(loss_err <= 1e-4, f"{what}: losses differ card vs "
          f"CPU by {loss_err}: {l_gpu} vs {l_cpu}")
    worst, worst_name = 0.0, None
    for n, want in g_cpu.items():
        got = g_gpu[n]
        check((got is None) == (want is None), f"{what}: "
              f"gradient of {n} present on one side only")
        if want is None:
            continue
        err = float((got - want).abs().max())
        tol = 1e-3 * float(want.abs().max()) + 1e-5
        check(err <= tol, f"{what}: gradient {n} max abs err "
              f"{err} > {tol}")
        rel = err / tol
        if rel > worst:
            worst, worst_name = rel, n
    print(f"{what}: losses agree card vs CPU (max abs err "
          f"{loss_err:.2e}, tolerance 1e-4): {json.dumps(l_gpu)}; "
          f"{len(g_cpu)} gradients agree, worst at {worst:.3f} of its "
          f"tolerance ({worst_name})")
    return l_gpu


G3_BUILDINGS = 3         # the 3G6c phase's served buildings (1 warms up)
G3_STEPS = 4             # its training steps (the first warms up)
KERNELS_3G6C = ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
                "subm_match", "rotated_iou")


def groups_3g6c_path(cfg, scenes, dev, tcfg=None, rcfg=None):
    """The separate-classifier (3G6c) configuration: ``cfg`` (at full
    width full_scale_config() with the groups (("wall",), ("ceiling",
    "floor")), seeded random weights) serves G3_BUILDINGS buildings
    through run_inference and trains G3_STEPS Trainer steps, with launch
    counts set to 0 just before each and read just after. Checks finite
    detections with original labels in 1..5, 4 losses per group all
    finite, moved parameters, and A, dFeats, dW, B and C launched; prints
    s/building, s/step, peak memory and C's launches per building and per
    step. Then at the small configs: ``tcfg`` (grouped) predict and one
    training step card against CPU, and ``rcfg`` (rpn_only) one serve
    and one training step on the card. Returns {path: launches}."""
    import shutil
    from detection_3d_tpu_torch.engine.inference import (
        make_predict_fn, pad_scene, run_inference)
    from detection_3d_tpu_torch.engine.trainer import Trainer
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from detection_3d_tpu_torch.ops import cuda_lib
    g = cfg.group_num
    check(g == 3, f"3g6c: {g} groups")
    n_fg = cfg.num_classes - 1

    model = SparseRCNN(cfg, seed=0)
    predict = make_predict_fn(cfg, model, device=dev)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    preds, _, sec = run_inference(cfg, model, scenes[:G3_BUILDINGS],
                                  device=dev, predict_fn=predict)
    wall = time.perf_counter() - t0
    serve = dict(cuda_lib.launches)
    # a replayed building calls no wrapper: count over the others
    replays = predict.graphed.replays if predict.graphed else 0
    check(predict.graphed is None or replays == len(preds) - 1,
          f"3g6c serving: {replays} replays of {len(preds)} buildings")
    wrapped = len(preds) - replays
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for i, p in enumerate(preds):
        check(p["true_num"] > 0 and p["boxes"].shape[0] > 0,
              f"3g6c building {i}: no voxels or no detections")
        check(bool(np.isfinite(p["boxes"]).all()
                   and np.isfinite(p["scores"]).all()),
              f"3g6c building {i}: non-finite detections")
        check(int(p["labels"].min()) >= 1 and int(p["labels"].max()) <= n_fg,
              f"3g6c building {i}: labels {np.unique(p['labels'])} outside "
              f"1..{n_fg}")
    labels = np.unique(np.concatenate([p["labels"] for p in preds]))
    print(f"3g6c serving: {len(preds)} buildings in {wall:.2f} s, "
          f"{sec:.4f} s/building over buildings 2..{len(preds)} (host "
          f"clock, padded arrays in -> detections on host), peak device "
          f"memory {serve_peak:.2f} GiB, {g} groups x "
          f"{cfg.roi_detections_per_img} rows, labels "
          f"{labels.tolist()}, detections "
          f"{[int(p['boxes'].shape[0]) for p in preds]}, graph replays "
          f"{replays}, C launches per eager or capturing building "
          f"{serve['rotated_iou'] / wrapped:.2f}, launches (wrapper calls) "
          f"{json.dumps(serve)}")
    del preds

    out_dir = cuda_lib.BUILD_DIR / "train_3g6c_smoke"   # gitignored, removed
    trainer = Trainer(cfg, output_dir=str(out_dir), device=dev)
    state = trainer.init_state(model=model)
    before = [p.detach().clone() for p in state.model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    state = trainer.train(scenes[:G3_STEPS], state, epochs=1, seed=0)
    wall = time.perf_counter() - t0
    train = dict(cuda_lib.launches)
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    names = [f"loss_{k}_{gi}" for gi in range(g)
             for k in ("objectness", "rpn_box_reg", "classifier_roi",
                       "box_reg_roi")]
    check(len(trainer.history) == G3_STEPS, "3g6c training: steps missing")
    for i, (total, losses, ok, _) in enumerate(trainer.history):
        check(sorted(losses) == sorted(names),
              f"3g6c training step {i}: losses {sorted(losses)}")
        check(np.isfinite(total) and all(np.isfinite(v)
                                         for v in losses.values()),
              f"3g6c training step {i}: non-finite loss {losses}")
    check(state.solver.count >= 1, "3g6c training: no step was applied")
    moved = sum(int(not torch.equal(p.detach(), b))
                for p, b in zip(state.model.parameters(), before))
    check(moved > 0, "3g6c training: the parameters did not change")
    for path, counts in (("serving", serve), ("training", train)):
        for name in KERNELS_3G6C:
            if path == "serving" and name.startswith("gather_conv_d"):
                continue
            check(counts[name] > 0, f"3g6c {path}: kernel {name} was not "
                  "launched")
    secs = [h[3] for h in trainer.history]
    step_s = sum(secs[1:]) / max(len(secs) - 1, 1)
    print(f"3g6c training: {len(secs)} steps in {wall:.2f} s, {step_s:.4f} "
          f"s/step over steps 2..{len(secs)} (host clock: scene fetched "
          f"and padded -> losses on the host), peak device memory "
          f"{train_peak:.2f} GiB, parameters moved {moved}/{len(before)}, "
          f"C launches per step {train['rotated_iou'] / len(secs):.2f}, "
          f"launches {json.dumps(train)}")
    print("3g6c training losses (last step): "
          + json.dumps({k: trainer.history[-1][1][k] for k in names}))
    del trainer, state, model, before
    shutil.rmtree(out_dir, ignore_errors=True)

    out = {"serve_3g6c": serve, "train_3g6c": train,
           "report": {"s_per_building": sec, "s_per_step": step_s,
                      "serve_peak_gib": serve_peak,
                      "train_peak_gib": train_peak,
                      "c_per_building": serve["rotated_iou"] / wrapped,
                      "c_per_step": train["rotated_iou"] / G3_STEPS}}
    if tcfg is not None:
        scene = tiny_scene(tcfg)
        got = tiny_predict_card_vs_cpu(tcfg, scene, card=dev,
                                       what="3g6c small building")
        check(got[:, 8].min() >= 1 and got[:, 8].max() <= n_fg,
              "3g6c small building: labels outside the original ids")
        tiny_train_card_vs_cpu(tcfg, scene, card=dev,
                               what="3g6c tiny training step")
    if rcfg is not None:
        scene = tiny_scene(rcfg)
        rmodel = SparseRCNN(rcfg, seed=0)
        rpredict = make_predict_fn(rcfg, rmodel, device=dev)
        rbatch = pad_scene(rcfg, scene)
        cuda_lib.reset_launches()
        # eager, the capture, a replay: each bit equal to the first (the
        # voxels' atomic feature sums under deterministic algorithms)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            served = [rpredict(rbatch) for _ in range(3)]
        finally:
            torch.use_deterministic_algorithms(False)
        packed_out, true_num = served[0]
        check(all(torch.equal(o, packed_out) and torch.equal(t, true_num)
                  for o, t in served[1:]),
              "rpn_only serve: a captured or replayed forward differs from "
              "the eager one")
        rreplays = rpredict.graphed.replays if rpredict.graphed else None
        check(rreplays in (None, 2), f"rpn_only serve: {rreplays} replays")
        a = packed_out.cpu().numpy()
        v = a[:, 9] > 0.5
        check(v.any() and bool(np.isfinite(a[v, :8]).all())
              and bool((a[v, 8] == 1).all())
              and bool((np.diff(a[v, 7]) <= 0).all()),
              "rpn_only serve: proposals not finite, labelled 1 and in "
              "descending objectness")
        rdir = cuda_lib.BUILD_DIR / "train_rpn_only_smoke"
        trainer = Trainer(rcfg, output_dir=str(rdir), device=dev)
        state = trainer.init_state(model=rmodel)
        gen = torch.Generator(device=dev).manual_seed(0)
        total, losses, ok, _ = trainer.step(state, pad_scene(rcfg, scene),
                                            gen)
        rpn = dict(cuda_lib.launches)
        for name in ("gather_conv", "rotated_iou"):
            check(rpn[name] > 0, f"rpn_only: kernel {name} was not "
                  "launched")
        check(ok and np.isfinite(total) and sorted(losses) == [
            "loss_objectness", "loss_rpn_box_reg"],
            f"rpn_only training step: {total} {losses} ok={ok}")
        print(f"rpn_only (small config): {int(v.sum())} proposals served "
              f"3 times (graph replays {rreplays}, bit equal), one "
              f"training step {json.dumps(losses)}, launches (wrapper "
              f"calls) {json.dumps(rpn)}")
        shutil.rmtree(rdir, ignore_errors=True)
        out["rpn_only"] = rpn
    return out


PIPE_BUILDINGS = 6       # buildings of each pipelined run (unit 0 warms up)
# (pack_mode, batch_size, pack_workers) of the pipelined runs, in the
# order they run: both modes at batch 1 and 2 with the default 2
# workers, and the pack-bound pyramid mode with 4
PIPE_SETTINGS = (("pyramid", 1, 2), ("table", 1, 2), ("pyramid", 2, 2),
                 ("table", 2, 2), ("pyramid", 1, 4))


def _field_mismatches(got, want):
    """Entries that differ (shape or dtype apart: every entry)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return max(got.numel(), want.numel(), 1)
    return int((got != want).sum())


def host_pyramid_check(cfg, scene, dev):
    """The host pyramid of one building against the card's: the C++ pack
    against the numpy pack_pyramid byte for byte, then unpack_pyramid of
    the C++ pack against build_pyramid (kernel B's books and masks) on
    unpack_table of the same pack, every table, book and row order bit
    equal, with per-field mismatch counts. Returns the numpy pack's
    seconds."""
    from detection_3d_tpu_torch.data.native_packer import pack_pyramid_native
    from detection_3d_tpu_torch.data.packing import to_device, unpack_table
    from detection_3d_tpu_torch.data.pyramid_packing import (
        pack_pyramid, unpack_pyramid)
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    t0 = time.perf_counter()
    want = pack_pyramid(cfg, scene)
    numpy_s = time.perf_counter() - t0
    got = pack_pyramid_native(cfg, scene)
    check(set(got) == set(want), "C++ pack: fields differ from numpy's")
    bytes_off = {}
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        bytes_off[k] = int(g.dtype != w.dtype or g.tobytes() != w.tobytes())
    check(not any(bytes_off.values()), "C++ pack differs from numpy's in "
          f"{sorted(k for k, v in bytes_off.items() if v)}")
    with torch.inference_mode():
        packed = to_device(got, dev)
        host = unpack_pyramid(cfg, packed)
        card = build_pyramid(unpack_table(cfg, packed), cfg)
        per = {}
        for k, (a, b) in enumerate(zip(host["tables"], card["tables"],
                                       strict=True)):
            for f in ("coords", "hi", "lo", "keys", "num"):
                per[f"table{k}.{f}"] = _field_mismatches(getattr(a, f),
                                                         getattr(b, f))
        books = [(f"{key}[{i}]", a, b) for key in ("subm", "down", "up")
                 for i, (a, b) in enumerate(zip(host[key], card[key],
                                                strict=True))]
        for slot, (t, b) in card["bev"].items():
            ht, a = host["bev"][slot]
            for f in ("coords", "hi", "lo", "keys", "num"):
                per[f"bev{slot}.{f}"] = _field_mismatches(getattr(ht, f),
                                                          getattr(t, f))
            books.append((f"bev{slot}", a, b))
        for name, a, b in books:
            per[f"{name}.idx"] = _field_mismatches(a.idx, b.idx)
            for f in ("perm", "masks"):
                per[f"{name}.order.{f}"] = _field_mismatches(
                    getattr(a.order, f), getattr(b.order, f))
    bad = {k: v for k, v in per.items() if v}
    print("host pyramid against the card's:", json.dumps(
        {"fields": len(per), "fields_differing": len(bad),
         "numpy_vs_cpp_fields_byte_equal": len(bytes_off),
         "mismatches": per}))
    check(not bad, f"host pyramid differs from build_pyramid's in {bad}")
    return numpy_s


def _nbytes(d):
    return int(sum(np.asarray(v).nbytes for v in d.values()))


def _spread(secs):
    secs = sorted(secs)
    return {"min_s": secs[0], "median_s": float(np.median(secs)),
            "seconds": secs}


def host_pack_times(cfg, scene, dev, numpy_pyramid_s, repeats=3):
    """Host clock of one building's pack in each form (numpy and C++,
    table and pyramid, the C++ pyramid on 1, 2, 4 and 8 threads), the
    bytes each form ships, and the host->device copy of each, from
    pageable memory and pinned (the pinning timed apart)."""
    from detection_3d_tpu_torch.data.native_packer import (
        pack_pyramid_native, pack_table_native)
    from detection_3d_tpu_torch.data.packing import (
        pack_scene, pack_table, to_device)
    from detection_3d_tpu_torch.engine.trainer import pad_scene
    runs = {"pad_scene (raw)": lambda: pad_scene(cfg, scene),
            "pack_scene numpy": lambda: pack_scene(cfg, scene),
            "pack_table numpy": lambda: pack_table(cfg, scene),
            "pack_table C++ 1 thread": lambda: pack_table_native(cfg, scene)}
    for n in (1, 2, 4, 8):
        runs[f"pack_pyramid C++ {n} threads"] = \
            lambda n=n: pack_pyramid_native(cfg, scene, n_threads=n)
    packs, times = {}, {}
    for name, fn in runs.items():
        secs = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            packs[name] = fn()
            secs.append(time.perf_counter() - t0)
        times[name] = _spread(secs)
    times["pack_pyramid numpy"] = _spread([numpy_pyramid_s])
    forms = {"raw": packs["pad_scene (raw)"],
             "pack_scene": packs["pack_scene numpy"],
             "pack_table": packs["pack_table C++ 1 thread"],
             "pack_pyramid": packs["pack_pyramid C++ 8 threads"]}
    pyr = forms["pack_pyramid"]
    kinds = {"subm idx": "subm", "down idx": "down", "up idx": "up",
             "bev idx": "bev"}
    makeup = {label: sum(v.nbytes for k, v in pyr.items()
                         if k.startswith(pre) and k.endswith("_idx"))
              for label, pre in kinds.items()}
    makeup["row orders (perm + masks)"] = sum(
        v.nbytes for k, v in pyr.items() if k.endswith(("_perm", "_masks")))
    makeup["tables and the rest"] = _nbytes(pyr) - sum(makeup.values())
    copies = {}
    for form, d in forms.items():
        plain, pin, pinned = [], [], []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            to_device(d, dev)
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            host = {k: torch.as_tensor(v).pin_memory() for k, v in d.items()}
            pin.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            to_device(host, dev, non_blocking=True)
            torch.cuda.synchronize()
            pinned.append(time.perf_counter() - t0)
        copies[form] = {"bytes": _nbytes(d), "pageable_copy": _spread(plain),
                        "pin_memory": _spread(pin),
                        "pinned_copy": _spread(pinned)}
    line = {"pack": times, "copy": copies, "pyramid_bytes": makeup}
    print("host pack of one building:", json.dumps(line))
    return line


def input_layers_check(cfg, scene, dev):
    """The points form's input layer (pack_scene, voxelized on the card)
    against the table form's (pack_table on the host) for one building:
    coords, keys, num and true_num bit equal; the features' largest
    difference (the one quantizes each point, the other each voxel
    mean), which must stay within the two quantizations' steps."""
    from detection_3d_tpu_torch.data.packing import (
        pack_scene, pack_table, to_device, unpack_batch, unpack_table)
    from detection_3d_tpu_torch.models.detector import voxelize_points
    with torch.inference_mode():
        b = unpack_batch(cfg, to_device(pack_scene(cfg, scene), dev))
        pts = voxelize_points(cfg, b["points"], b["feats"], b["points_valid"])
        tab = unpack_table(cfg, to_device(pack_table(cfg, scene), dev))
        for f in ("coords", "hi", "lo", "keys", "num", "true_num"):
            check(torch.equal(getattr(pts, f), getattr(tab, f)),
                  f"points and table forms: input layer {f} differs")
        d = (pts.feats - tab.feats)[tab.row_valid].abs().amax(0).cpu()
    line = {"xyz_max_abs": float(d[:3].max()),
            "rgb_max_abs": float(d[3:6].max()),
            "normal_max_abs": float(d[6:9].max())}
    scale = cfg.sparse3d.voxel_scale
    check(line["xyz_max_abs"] <= (1 / 8 + 1 / 256) / scale + 1e-5
          and line["rgb_max_abs"] <= 1 / 255 + 1e-5
          and line["normal_max_abs"] <= 1 / 127 + 1e-5,
          f"points and table forms: features apart by {line}")
    return line


def _rows_close(a, b, tol):
    """Largest difference of two sorted valid-row sets, and the rows of
    the larger set that have no partner within ``tol`` (all when the
    counts differ)."""
    if a.shape != b.shape:
        return float("inf"), max(a.shape[0], b.shape[0])
    if a.shape[0] == 0:
        return 0.0, 0
    d = np.abs(a[:, :9] - b[:, :9]).max(1)
    return float(d.max()), int((d > tol).sum())


def packed_serving_path(cfg, scenes, dev):
    """The packed forms and the pipelined loop at full width.

    One building's host pyramid against the card's
    (:func:`host_pyramid_check`) and its pack times
    (:func:`host_pack_times`). Then PIPE_BUILDINGS buildings through the
    sequential predict of each packed form (True, "table", "pyramid";
    launch counts set to 0 before each and read after): "table" and
    "pyramid" must agree within 1e-4, True is held against "table" as
    sets (the count of detections off by more than 1e-4 printed: True
    averages its quantized points on the card), and every form must give
    the same true_num. Then run_inference(pipelined=True) in each of
    PIPE_SETTINGS, alternating with the raw
    sequential run_inference: detections within 1e-6 of the sequential
    packed predict on the same packs, A and C launched in every run, B in
    table mode and not in pyramid mode; each run printed with s/building,
    timings, peak memory, launches and, from a second run under the
    profiler, the device's idle share. Returns the launches by path."""
    from detection_3d_tpu_torch.data.native_packer import (
        pack_pyramid_native, pack_table_native)
    from detection_3d_tpu_torch.data.packing import pack_scene
    from detection_3d_tpu_torch.engine.inference import (
        make_predict_fn, run_inference)
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from detection_3d_tpu_torch.ops import cuda_lib
    numpy_s = host_pyramid_check(cfg, scenes[0], dev)
    pack_line = host_pack_times(cfg, scenes[0], dev, numpy_s)
    main_scenes = scenes[:PIPE_BUILDINGS]
    model = SparseRCNN(cfg, seed=0)
    packers = {True: pack_scene, "table": pack_table_native,
               "pyramid": pack_pyramid_native}
    names = {True: "serve_points", "table": "serve_table",
             "pyramid": "serve_pyramid"}
    launches, seq = {}, {}
    for form, pack in packers.items():
        predict = make_predict_fn(cfg, model, device=dev, packed=form)
        packs = [pack(cfg, s) for s in main_scenes]
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        outs = [predict(p) for p in packs]
        outs = [(o.cpu().numpy(), int(t)) for o, t in outs]
        launches[names[form]] = dict(cuda_lib.launches)
        seq[form] = outs
        del packs
    for i in range(len(main_scenes)):
        tn = {form: seq[form][i][1] for form in packers}
        check(len(set(tn.values())) == 1, f"building {i}: true_num by "
              f"form {tn}")
    points_vs_table = input_layers_check(cfg, main_scenes[0], dev)
    form_diff = {"table_vs_pyramid_max_abs": 0.0,
                 "points_vs_table_max_abs": 0.0,
                 "points_vs_table_rows_off": []}
    for i in range(len(main_scenes)):
        rows = {form: valid_rows(torch.from_numpy(seq[form][i][0]))
                for form in packers}
        for form in packers:
            check(rows[form].shape[0] > 0
                  and bool(np.isfinite(rows[form]).all()),
                  f"building {i}, packed={form}: no or non-finite "
                  "detections")
        d, off = _rows_close(rows["table"], rows["pyramid"], 1e-4)
        check(off == 0, f"building {i}: table and pyramid forms differ by "
              f"{d} in {off} detections")
        form_diff["table_vs_pyramid_max_abs"] = max(
            form_diff["table_vs_pyramid_max_abs"], d)
        d, off = _rows_close(rows[True], rows["table"], 1e-4)
        form_diff["points_vs_table_max_abs"] = max(
            form_diff["points_vs_table_max_abs"], d)
        form_diff["points_vs_table_rows_off"].append(off)
    print("packed forms:", json.dumps(
        {"buildings": len(main_scenes), **form_diff,
         "points_vs_table_input_layer": points_vs_table,
         "launches": {names[f]: launches[names[f]] for f in packers}}))
    for form in ("table", "pyramid"):
        ln = launches[names[form]]
        check(ln["gather_conv"] > 0 and ln["rotated_iou"] > 0,
              f"packed={form}: kernel A or C was not launched")
        check((ln["subm_match"] > 0) == (form == "table"),
              f"packed={form}: kernel B launches {ln['subm_match']}")

    raw_predict = make_predict_fn(cfg, model, device=dev)

    def raw_run():
        torch.cuda.synchronize()
        _, _, sec = run_inference(cfg, model, main_scenes, device=dev,
                                  predict_fn=raw_predict)
        return sec

    raw_secs = [raw_run()]
    runs = []
    for mode, bs, workers in PIPE_SETTINGS:
        def pipelined(timings=None):
            torch.cuda.synchronize()
            return run_inference(cfg, model, main_scenes, device=dev,
                                 pipelined=True, pack_workers=workers,
                                 pack_mode=mode, batch_size=bs,
                                 timings=timings)
        tm = {}
        torch.cuda.reset_peak_memory_stats()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        preds, _, sec = pipelined(tm)
        wall = time.perf_counter() - t0
        ln = dict(cuda_lib.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        err = 0.0
        for i, p in enumerate(preds):
            a, tn = seq[mode][i]
            v = a[:, 9] > 0.5
            check(p["true_num"] == tn and p["boxes"].shape[0] == int(v.sum())
                  and np.array_equal(p["labels"], a[v, 8].astype(np.int32)),
                  f"pipelined {mode} B={bs}: building {i} differs from the "
                  "sequential packed predict")
            err = max(err, float(np.abs(p["boxes"] - a[v, :7]).max(
                initial=0.0)), float(np.abs(p["scores"] - a[v, 7]).max(
                    initial=0.0)))
        check(err <= 1e-6, f"pipelined {mode} B={bs}: max abs err {err} "
              "against the sequential packed predict")
        check(ln["gather_conv"] > 0 and ln["rotated_iou"] > 0,
              f"pipelined {mode} B={bs}: kernel A or C was not launched")
        check((ln["subm_match"] > 0) == (mode == "table"),
              f"pipelined {mode} B={bs}: kernel B launches "
              f"{ln['subm_match']}")
        if bs == 1 and workers == 2:
            launches[f"pipelined_{mode}"] = ln
        prof = _profile(pipelined)
        line = {"pack_mode": mode, "batch_size": bs,
                "pack_workers": workers, "buildings": len(preds),
                "s_per_building": sec, "wall_s": wall, "timings": tm,
                "max_abs_err_vs_sequential": err,
                "peak_device_memory_gib": peak, "launches": ln,
                "profile": {**_brief(prof, (
                    "busy_ms", "sum_ms", "memcpy_ms", "span_ms",
                    "idle_share", "streams", "port_kernels_ms")),
                    # the reading before the union: overlaps counted twice
                    "idle_share_of_sum": 1.0 - prof["sum_ms"]
                    / prof["span_ms"]}}
        print("pipelined serving:", json.dumps(line))
        runs.append(line)
        raw_secs.append(raw_run())
    print("raw sequential serving between the pipelined runs: "
          + json.dumps({"s_per_building": raw_secs,
                        "buildings": len(main_scenes)}))
    del model
    return launches, {"pack": pack_line, "forms": form_diff,
                      "pipelined": runs, "raw_s_per_building": raw_secs}


INPUT_BUILDINGS = 6      # the training-input phase's epoch (6 steps)
RESIDENT_CHUNK = 6       # train_resident: 2 epochs, one chunk each
RESIDENT_EPOCHS = 2
SCAN_K = 3               # scan_steps of the scanned epoch
INPUT_RUNS = 2           # alternating loader / list epochs of each form
BWD_BOOK_FIELDS = ("t_idx", "entries", "starts")


def scene_packs_check(scenes, root):
    """Write ``scenes`` as scene packs under ``root`` (bytes and write
    time), then read them back through NativeSceneLoader and hold every
    array against read_scene_pack. Returns (paths, report)."""
    from detection_3d_tpu_torch.data.native_loader import NativeSceneLoader
    from detection_3d_tpu_torch.data.scene_pack import (
        read_scene_pack, write_scene_pack)
    root.mkdir(parents=True, exist_ok=True)
    paths = [str(root / f"train_{i:06d}.spk") for i in range(len(scenes))]
    t0 = time.perf_counter()
    for path, scene in zip(paths, scenes):
        write_scene_pack(path, scene)
    write_s = time.perf_counter() - t0
    loader = NativeSceneLoader(paths, n_prefetch=4, n_threads=2)
    t0 = time.perf_counter()
    got = list(loader.epoch())
    read_s = time.perf_counter() - t0
    loader.close()
    for i, (g, path) in enumerate(zip(got, paths)):
        want = read_scene_pack(path)
        check(list(g) == list(want) and all(
            g[k].dtype == want[k].dtype and np.array_equal(g[k], want[k])
            for k in want), f"scene pack {i}: the C++ loader differs from "
              "read_scene_pack")
    report = {"files": len(paths),
              "bytes": sum(Path(p).stat().st_size for p in paths),
              "write_s": write_s, "loader_read_s": read_s}
    print("scene packs:", json.dumps(report))
    return paths, report


def host_training_pyramid_check(cfg, scene, dev, repeats=3):
    """One building's training pack (pack_pyramid_native(...,
    backward=True)) byte for byte against the numpy pack, unpacked on the
    card with its backward books against build_pyramid(..., backward=
    True) on unpack_table of the same pack: every BackwardBook field
    (t_idx, entries, starts, t_order's perm and masks, reversed) bit
    equal, with per-field mismatch counts. Prints the backward fields'
    bytes and the pack times with and without them. Returns the C++
    pack."""
    from detection_3d_tpu_torch.data.native_packer import pack_pyramid_native
    from detection_3d_tpu_torch.data.packing import to_device, unpack_table
    from detection_3d_tpu_torch.data.pyramid_packing import (
        pack_pyramid, pyramid_pack_spec, unpack_pyramid)
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    t0 = time.perf_counter()
    want = pack_pyramid(cfg, scene, backward=True)
    numpy_s = time.perf_counter() - t0
    times = {False: [], True: []}
    for _ in range(repeats):
        for backward in (False, True):
            t0 = time.perf_counter()
            got = pack_pyramid_native(cfg, scene, backward=backward)
            times[backward].append(time.perf_counter() - t0)
    check(set(got) == set(want), "C++ training pack: fields differ from "
          "numpy's")
    off = sorted(k for k in want
                 if np.asarray(got[k]).dtype != np.asarray(want[k]).dtype
                 or np.asarray(got[k]).tobytes()
                 != np.asarray(want[k]).tobytes())
    check(not off, f"C++ training pack differs from numpy's in {off}")
    serving = set(pyramid_pack_spec(cfg))
    extra = {k: v for k, v in got.items()
             if k in pyramid_pack_spec(cfg, backward=True)
             and k not in serving}
    per = {}
    with torch.inference_mode():
        packed = to_device(got, dev)
        host = unpack_pyramid(cfg, packed, backward=True)
        card = build_pyramid(unpack_table(cfg, packed), cfg, backward=True)
        pairs = [(f"{key}[{i}].bwd", a.bwd, b.bwd)
                 for key in ("subm", "down", "up")
                 for i, (a, b) in enumerate(zip(host[key], card[key],
                                                strict=True))]
        pairs += [(f"bev{s}.bwd", host["bev"][s][1].bwd, b.bwd)
                  for s, (_, b) in card["bev"].items()]
        for name, a, b in pairs:
            for f in BWD_BOOK_FIELDS:
                per[f"{name}.{f}"] = _field_mismatches(getattr(a, f),
                                                       getattr(b, f))
            for f in ("perm", "masks"):
                per[f"{name}.t_order.{f}"] = _field_mismatches(
                    getattr(a.t_order, f), getattr(b.t_order, f))
            per[f"{name}.reversed"] = int(a.reversed != b.reversed)
        del packed, host, card
    bad = {k: v for k, v in per.items() if v}
    line = {"fields": len(per), "fields_differing": len(bad),
            "numpy_vs_cpp_arrays_byte_equal": len(want),
            "backward_bytes": _nbytes(extra),
            "backward_bytes_by_kind": {
                "entries": sum(v.nbytes for k, v in extra.items()
                               if k.endswith("_entries")),
                "bev_transposes": sum(v.nbytes for k, v in extra.items()
                                      if k.endswith("_t_idx")),
                "bev_transpose_row_orders": sum(
                    v.nbytes for k, v in extra.items()
                    if k.endswith(("_t_perm", "_t_masks"))),
                "starts": sum(v.nbytes for k, v in extra.items()
                              if k.endswith("_starts"))},
            "entries": {k[:-len("_entries")]: int(v.shape[0])
                        for k, v in extra.items() if k.endswith("_entries")},
            "pack_bytes": _nbytes(got),
            "pack_cpp_8_threads": {"without_books": _spread(times[False]),
                                   "with_books": _spread(times[True])},
            "pack_numpy_with_books_s": numpy_s,
            "mismatches": per}
    print("host training pyramid against the card's:", json.dumps(line))
    check(not bad, f"host training pyramid differs from build_pyramid's "
          f"in {bad}")
    return got


def _grad_report(got, want):
    """Worst gradient difference against 1e-3 of the largest entry +
    1e-5 (the card-vs-CPU training check's tolerance), as a share of it,
    and the largest absolute difference."""
    worst, worst_name, max_err = 0.0, None, 0.0
    for n, w in want.items():
        g = got[n]
        check((g is None) == (w is None), f"gradient of {n} present on one "
              "side only")
        if w is None:
            continue
        err = float((g - w).abs().max())
        rel = err / (1e-3 * float(w.abs().max()) + 1e-5)
        max_err = max(max_err, err)
        if rel > worst:
            worst, worst_name = rel, n
    return {"worst_share_of_tolerance": worst, "worst": worst_name,
            "max_abs_err": max_err}


def packed_vs_table_step(cfg, packed_np, dev):
    """The packed training forward and backward (the host pyramid with
    its books) against the table-form one (unpack_table's table, the
    pyramid built on the card) with the same weights and priorities, and
    the table form against itself. Under torch's deterministic algorithms
    (warn_only; the ops without one are listed) the table form must
    repeat its bits and the packed form must give the same bits: losses
    and every gradient. In the default mode scatters sum through
    atomics, so the gradients may differ from run to run; their largest
    differences against 1e-3 of the largest entry +
    1e-5 (the card-vs-CPU check's tolerance) are printed, and the losses
    must agree within 1e-4 of the largest."""
    import copy
    import warnings
    from detection_3d_tpu_torch.data.packing import to_device, unpack_table
    from detection_3d_tpu_torch.data.pyramid_packing import unpack_pyramid
    from detection_3d_tpu_torch.engine.trainer import total_loss
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from detection_3d_tpu_torch.models.structures import Boxes3D
    base = SparseRCNN(cfg, seed=0)
    g = torch.Generator(device=dev).manual_seed(3)
    pri = {k: torch.rand((n,), generator=g, device=dev)
           for k, n in base.priority_shapes().items()}
    b = to_device(packed_np, dev)

    def run(form):
        model = copy.deepcopy(base).to(dev).train()
        pyr = unpack_pyramid(cfg, b, backward=True) \
            if form == "packed" else None
        table = pyr["tables"][0] if pyr else unpack_table(cfg, b)
        losses = model(table, Boxes3D(b["gt_boxes"], b["gt_valid"]),
                       b["gt_labels"], priorities=pri, pyramid=pyr)
        total_loss(losses).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n: None if p.grad is None else p.grad.float().cpu()
                 for n, p in model.named_parameters()})

    forms = ("table", "packed", "table_again")
    res = {"default": {f: run(f) for f in forms}}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            res["deterministic"] = {f: run(f) for f in forms}
        finally:
            torch.use_deterministic_algorithms(False)
    no_det = sorted({str(w.message).split(" does not have")[0][:120]
                     for w in caught if "determinis" in str(w.message)})
    line = {"ops_without_a_deterministic_algorithm": no_det}
    for mode, r in res.items():
        lw, gw = r["table"]
        for form in ("packed", "table_again"):
            lg, gg = r[form]
            same = lg == lw and all(
                (gg[n] is None and gw[n] is None) or (
                    gg[n] is not None and gw[n] is not None
                    and torch.equal(gg[n], gw[n])) for n in gw)
            line[f"{mode}.{form}"] = {
                "losses": lg, "same_bits_as_table": same,
                "loss_max_abs_err": max(abs(lg[k] - lw[k]) for k in lw),
                **_grad_report(gg, gw)}
    print("packed training step against the table-form step:",
          json.dumps(line))
    for mode, r in res.items():
        for form in forms:
            check(all(np.isfinite(v) for v in r[form][0].values()),
                  f"{mode} {form} step: non-finite losses")
    lw = res["default"]["table"][0]
    check(line["default.packed"]["loss_max_abs_err"]
          <= 1e-4 * max(1.0, *(abs(v) for v in lw.values())),
          f"packed step: losses differ from the table-form step's: {line}")
    check(line["deterministic.table_again"]["same_bits_as_table"],
          "deterministic mode: the table-form step did not repeat its bits")
    check(line["deterministic.packed"]["same_bits_as_table"],
          "deterministic mode: the packed step's losses or gradients differ "
          f"from the table-form step's: {line['deterministic.packed']}")
    return line


class _Fingerprints:
    """Record each scene the trainer pads (its point count and first
    point), to compare the scene order of two runs."""

    def __enter__(self):
        from detection_3d_tpu_torch.engine import trainer as trainer_mod
        self.mod, self.pad, self.seen = trainer_mod, trainer_mod.pad_scene, []

        def pad(cfg, scene):
            self.seen.append((int(scene["points"].shape[0]),
                              tuple(float(x) for x in scene["points"][0])))
            return self.pad(cfg, scene)
        trainer_mod.pad_scene = pad
        return self

    def __exit__(self, *exc):
        self.mod.pad_scene = self.pad


def _history_line(history, skip_first=1):
    secs = [h[3] for h in history]
    timed = secs[skip_first:] or secs
    return {"steps": len(secs), "applied": sum(bool(h[2]) for h in history),
            "s_per_step": sum(timed) / len(timed), "step_seconds": secs,
            "totals": [h[0] for h in history]}


def _check_history(name, history, steps):
    check(len(history) == steps, f"{name}: {len(history)} steps, expected "
          f"{steps}")
    for i, (total, losses, ok, _) in enumerate(history):
        check(np.isfinite(total) and all(np.isfinite(v)
                                         for v in losses.values()),
              f"{name} step {i}: non-finite loss {losses}")
        check(ok, f"{name} step {i}: the update was not applied")


def _check_launches(name, ln, b_launches):
    for k in ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
              "rotated_iou"):
        check(ln[k] > 0, f"{name}: kernel {k} was not launched")
    check((ln["subm_match"] > 0) == b_launches,
          f"{name}: kernel B launches {ln['subm_match']}")


def train_input_path(cfg, scenes, dev):
    """The training input path at full width: scene packs and the C++
    loader (one epoch over the loader and one over the list, alternating,
    INPUT_RUNS each, same seed: same scene order, finite and applied
    steps), the host training pyramid (:func:`host_training_pyramid_check`),
    the packed step against the table-form step
    (:func:`packed_vs_table_step`), the packed step through
    Trainer.step, train_resident (chunk RESIDENT_CHUNK, RESIDENT_EPOCHS
    epochs; pack time, resident MB, s/step per chunk, peak memory, the
    non-finite count and a chunk under the profiler) and scan_steps =
    SCAN_K over the list. Launch counts are set to 0 before each path
    and read after: B on the loader and scanned paths, not on the packed
    and resident ones. Returns the launches by path."""
    import shutil
    from detection_3d_tpu_torch.data.native_loader import NativeSceneLoader
    from detection_3d_tpu_torch.data.native_packer import pack_pyramid_native
    from detection_3d_tpu_torch.data.packing import to_device
    from detection_3d_tpu_torch.engine.trainer import Trainer
    from detection_3d_tpu_torch.ops import cuda_lib
    root = cuda_lib.BUILD_DIR / "train_input_smoke"   # gitignored, removed
    shutil.rmtree(root, ignore_errors=True)
    main_scenes = scenes[:INPUT_BUILDINGS]
    paths, _ = scene_packs_check(main_scenes, root / "packs")
    launches = {}

    def trainer(name):
        return Trainer(cfg, output_dir=str(root / name), device=dev)

    runs = {"loader": [], "list": []}
    orders = {}
    for r in range(INPUT_RUNS):
        for form in ("loader", "list"):
            tr = trainer(f"{form}{r}")
            state = tr.init_state(seed=0, iters_per_epoch=len(main_scenes))
            src = NativeSceneLoader(paths) if form == "loader" \
                else main_scenes
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            with _Fingerprints() as fp:
                tr.train(src, state, epochs=1, seed=0)
            torch.cuda.synchronize()
            ln = dict(cuda_lib.launches)
            if form == "loader":
                src.close()
            _check_history(f"train over the {form}", tr.history,
                           len(main_scenes))
            _check_launches(f"train over the {form}", ln, True)
            launches.setdefault(f"train_{form}", ln)
            orders.setdefault(form, fp.seen)
            check(fp.seen == orders[form], f"{form}: scene order changed "
                  "between runs with the same seed")
            runs[form].append(_history_line(tr.history))
            del tr, state
    check(orders["loader"] == orders["list"], "loader and list epochs "
          "trained the scenes in different orders")
    print("loader against list epochs:", json.dumps(
        {"same_scene_order": True, "order_point_counts":
         [n for n, _ in orders["list"]],
         "s_per_step": {f: [r["s_per_step"] for r in runs[f]]
                        for f in runs},
         "runs": runs, "launches": {f: launches[f"train_{f}"]
                                    for f in runs}}))

    packed_np = host_training_pyramid_check(cfg, main_scenes[0], dev)
    packed_vs_table_step(cfg, packed_np, dev)
    tr = trainer("packed")
    state = tr.init_state(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    secs = []
    for i in range(3):
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        total, losses, ok, true_num = tr.step(state, packed_np, gen,
                                              packed="pyramid")
        secs.append(time.perf_counter() - t0)
        check(np.isfinite(total) and ok, f"packed step {i}: total {total}, "
              f"ok {ok}")
    launches["train_packed"] = dict(cuda_lib.launches)
    _check_launches("packed step", launches["train_packed"], False)
    print("packed training step (Trainer.step(packed='pyramid'), the numpy "
          "pack copied in each step):", json.dumps(
              {"step_seconds": secs, "s_per_step": sum(secs[1:]) / 2,
               "true_num": true_num, "launches_per_step":
               launches["train_packed"]}))
    del tr, state, packed_np

    tr = trainer("resident")
    state = tr.init_state(seed=0, iters_per_epoch=len(main_scenes))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    state = tr.train_resident(main_scenes, state, RESIDENT_EPOCHS, seed=0,
                              chunk=RESIDENT_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["train_resident"] = dict(cuda_lib.launches)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = RESIDENT_EPOCHS * len(main_scenes)
    _check_history("train_resident", tr.history, steps)
    _check_launches("train_resident", launches["train_resident"], False)
    check(tr.resident_skipped == 0, f"train_resident: {tr.resident_skipped} "
          "non-finite steps")
    chunk_s = [tr.history[c * RESIDENT_CHUNK][3]
               for c in range(steps // RESIDENT_CHUNK)]
    packs = [to_device(pack_pyramid_native(cfg, s, backward=True), dev)
             for s in main_scenes]
    gen = torch.Generator(device=dev).manual_seed(2)
    prof = _profile(lambda: tr.scan(state, packs, gen, packed="pyramid"))
    del packs
    resident = {"buildings": len(main_scenes), "chunk": RESIDENT_CHUNK,
                "epochs": RESIDENT_EPOCHS, "steps": len(tr.history),
                "pack_s": tr.pack_seconds,
                "resident_mb": tr.resident_bytes / 1e6,
                "s_per_step_by_chunk": chunk_s, "wall_s": wall,
                "peak_device_memory_gib": peak,
                "non_finite": tr.resident_skipped,
                "totals": [h[0] for h in tr.history],
                "launches": launches["train_resident"],
                "profile_of_one_more_chunk": _brief(prof, (
                    "busy_ms", "sum_ms", "memcpy_ms", "span_ms",
                    "idle_share", "streams", "port_kernels_ms", "top_ms"))}
    print("train_resident:", json.dumps(resident))
    del tr, state

    tr = trainer("scan")
    tr.scan_steps = SCAN_K
    state = tr.init_state(seed=0, iters_per_epoch=len(main_scenes))
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    tr.train(main_scenes, state, epochs=1, seed=0)
    torch.cuda.synchronize()
    launches["train_scan"] = dict(cuda_lib.launches)
    _check_history("scan_steps", tr.history, len(main_scenes))
    _check_launches("scan_steps", launches["train_scan"], True)
    scan = _history_line(tr.history, skip_first=SCAN_K)
    print(f"scan_steps = {SCAN_K}:", json.dumps(
        {**scan, "list_s_per_step": [r["s_per_step"] for r in runs["list"]],
         "launches": launches["train_scan"]}))
    del tr, state
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ---- the parallel phase: data parallelism, spatial sharding, dp x sp ------

PAR_DP_STEPS = 3         # data-parallel steps (the first is held against
                         # one process, the other two are timed)
PAR_TIMEOUT = 420        # seconds a launch of ranks may take
# the small spatial config's caps (tests/test_torch_spatial.py's)
SMALL_SHARD_CAPS = (4096, 4096, 2048, 1024)
SMALL_HALO_CAPS = (64, 64, 64, 32)
CAP_MARGIN = {"shard": 1.10, "halo": 1.25}   # over the measured counts


def tiny_spatial_config():
    """:func:`tiny_config` on a 128 x 128 x 64 grid with 4 scales and caps
    that hold every voxel of :func:`tiny_scene` (the spatial parity
    tests' config, tests/test_torch_spatial.spatial_cfg)."""
    from detection_3d_tpu_torch.config.defaults import (
        CapacityConfig, Sparse3DConfig)
    return tiny_config().replace(
        sparse3d=Sparse3DConfig(
            voxel_scale=20, voxel_full_scale=(128, 128, 64),
            nplanes_front=(8, 16, 16, 32), kernels=((2, 2, 2),) * 3,
            strides=((2, 2, 2),) * 3, nplane_map=16),
        caps=CapacityConfig(max_points=8192,
                            voxel_caps=(8192, 8192, 4096, 2048), max_gt=16))


def centered(scene, cfg):
    """``scene`` moved along x so that its middle sits at the grid's middle
    (the x = X/2 slab boundary of 2 shards crosses the building; the
    synthetic buildings start at x = 0)."""
    shift = cfg.sparse3d.voxel_full_scale[0] / 2 - float(
        scene["points"][:, 0].max() + scene["points"][:, 0].min()) / 2
    shift = float(np.floor(shift))
    out = dict(scene)
    out["points"] = scene["points"] + np.array([shift, 0, 0], np.float32)
    boxes = scene["gt_boxes"].copy()
    boxes[:, 0] += shift / cfg.sparse3d.voxel_scale
    out["gt_boxes"] = boxes
    return out


def _backend(n):
    """NCCL over distinct cards when there is one per rank, else gloo with
    every rank on cuda:0."""
    return "nccl" if torch.cuda.device_count() >= n else "gloo"


def _round_up(x, m):
    return -(-int(x) // m) * m


def measure_caps(cfg, batches, n_shards, dev):
    """Capacities for ``n_shards`` x-slabs, from the single-card pyramids
    of ``batches`` built under caps that hold every voxel (scale 0's cap
    at every scale): at each scale the voxel count (x 1.10, rounded up
    to 256, and no less than ``cfg``'s cap: the global caps, for the
    single card and the gathered maps, since ``cfg``'s own caps may
    subsample a scale, which a shard would do otherwise), the largest
    own row count of a shard (x 1.10, rounded up to 256) and the largest
    boundary column (the x-planes next to a slab edge; x 1.25, rounded
    up to 32). Returns (cfg with the global caps, shard_caps, halo_caps,
    measured)."""
    import dataclasses
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.models.detector import voxelize_points
    n = cfg.sparse3d.num_scales
    caps = cfg.caps.scale_caps(n)
    big = cfg.replace(caps=dataclasses.replace(cfg.caps,
                                               voxel_caps=(caps[0],) * n))
    total, own, col = [0] * n, [0] * n, [0] * n
    with torch.inference_mode():
        for b in batches:
            table0 = voxelize_points(big, *(torch.as_tensor(b[k]).to(dev)
                                            for k in ("points", "feats",
                                                      "points_valid")))
            for s, t in enumerate(build_pyramid(table0, big)["tables"]):
                check(int(t.true_num) <= t.capacity, f"scale {s}: "
                      f"{int(t.true_num)} voxels over {t.capacity}")
                total[s] = max(total[s], int(t.true_num))
                x = t.coords[:, 0][t.row_valid]
                w = t.spatial_size[0] // n_shards
                for d in range(n_shards):
                    own[s] = max(own[s], int(((x >= d * w)
                                              & (x < (d + 1) * w)).sum()))
                for d in range(1, n_shards):
                    for e in (d * w - 1, d * w):
                        col[s] = max(col[s], int((x == e).sum()))
    glob = tuple(max(c, _round_up(CAP_MARGIN["shard"] * t, 256))
                 for c, t in zip(caps, total))
    shard = tuple(max(256, _round_up(CAP_MARGIN["shard"] * o, 256))
                  for o in own)
    halo = tuple(max(32, _round_up(CAP_MARGIN["halo"] * c, 32)) for c in col)
    out_cfg = cfg.replace(caps=dataclasses.replace(cfg.caps,
                                                   voxel_caps=glob))
    return out_cfg, shard, halo, {"voxels": total, "own_rows": own,
                                  "boundary_column": col,
                                  "global_caps": glob}


def _digest(model):
    import hashlib
    flat = torch.cat([p.detach().reshape(-1).float() for p in
                      model.parameters()])
    return hashlib.sha1(flat.cpu().numpy().tobytes()).hexdigest()[:16]


class _CommBytes:
    """Count the bytes each rank receives through the collectives while
    in use: the halo and topology exchanges (parallel/spatial's
    gathers), the global maps' gathers and the all-reduces (BN's sums,
    the gradient buffer)."""

    def __init__(self):
        self.bytes = {"halo_exchange": 0, "map_gather": 0, "all_reduce": 0}

    def __enter__(self):
        import torch.distributed as dist
        from detection_3d_tpu_torch.parallel import collectives, spatial
        self._orig = (spatial._gather, collectives._gather,
                      collectives._reduce_sum)

        def counted(kind, fn):
            def wrapped(x, group=None):
                self.bytes[kind] += (x.numel() * x.element_size()
                                     * dist.get_world_size(group))
                return fn(x, group)
            return wrapped

        spatial._gather = counted("halo_exchange", self._orig[0])
        collectives._gather = counted("map_gather", self._orig[1])
        collectives._reduce_sum = counted("all_reduce", self._orig[2])
        return self

    def __exit__(self, *exc):
        from detection_3d_tpu_torch.parallel import collectives, spatial
        (spatial._gather, collectives._gather,
         collectives._reduce_sum) = self._orig


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _single_card_grads(cfg, model, batches, priorities, dev):
    """One process, one card: the mean over ``batches`` of the training
    losses, and the gradient of the mean loss (each building's loss /
    len(batches), backward accumulated), with the given draws."""
    from detection_3d_tpu_torch.engine.trainer import (
        batch_to_device, total_loss)
    from detection_3d_tpu_torch.models.detector import voxelize_points
    from detection_3d_tpu_torch.parallel.checks import grads
    model.zero_grad(set_to_none=True)
    sums = {}
    for b, pri in zip(batches, priorities):
        (pts, fts, valid), gt, gtl = batch_to_device(b, dev)
        losses = model(voxelize_points(cfg, pts, fts, valid), gt, gtl,
                       priorities={k: torch.as_tensor(v).to(dev)
                                   for k, v in pri.items()})
        if cfg.eval_in_train:
            losses = losses[0]
        total = total_loss(losses)
        (total / len(batches)).backward()
        for k, v in [("total", total), *losses.items()]:
            sums[k] = sums.get(k, 0.0) + float(v.detach()) / len(batches)
    return sums, grads(model)


def _dets_agree(got, want, what):
    """Detections (parallel/checks.detections dicts) as sets: equal
    labels, scores within 1e-3 and boxes within 5e-3
    (tests/test_spatial.py's tolerances)."""
    n = got["scores"].shape[0]
    check(n == want["scores"].shape[0], f"{what}: {n} detections, "
          f"{want['scores'].shape[0]} on one card")
    og = np.lexsort((got["scores"], got["labels"]))
    ow = np.lexsort((want["scores"], want["labels"]))
    check(np.array_equal(got["labels"][og], want["labels"][ow]),
          f"{what}: labels differ")
    err_s = float(np.abs(got["scores"][og] - want["scores"][ow]).max(
        initial=0.0))
    err_b = float(np.abs(got["boxes"][og] - want["boxes"][ow]).max(
        initial=0.0))
    check(err_s <= 1e-3 and err_b <= 5e-3, f"{what}: scores off by "
          f"{err_s}, boxes by {err_b}")
    return {"detections": n, "score_max_abs_err": err_s,
            "box_max_abs_err": err_b}


def _launches():
    from detection_3d_tpu_torch.ops import cuda_lib
    torch.cuda.synchronize()
    return dict(cuda_lib.launches)


def par_dp_rank(cfg, batches, priorities):
    """Rank job of the data-parallel check (2 ranks, one building each a
    step): rank 0 first takes the single-process step of the first two
    buildings with the same draws, under deterministic algorithms (its
    losses and gradients, and the single-card s/step over the two
    buildings, timed on a second run in the default mode); then
    PAR_DP_STEPS data-parallel
    steps (parallel/mesh.batched_train_step), the first deterministic
    with those draws and held against the single-process step, the
    others from the rank's generator and timed; the parameters' digest
    after every step, the launches of the steps and the peak memory."""
    import copy
    import warnings
    import torch.distributed as dist
    from detection_3d_tpu_torch.engine.solver import Solver
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.parallel.checks import grads
    from detection_3d_tpu_torch.parallel.mesh import (
        batched_train_step, make_mesh, rank_generator)
    warnings.simplefilter("ignore")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(axis="dp", device="cuda")
    dev, r = mesh.device, mesh.rank
    model = SparseRCNN(cfg, seed=0).to(dev).train()
    out = {"rank": r, "device": str(dev)}
    torch.use_deterministic_algorithms(True, warn_only=True)
    if r == 0:
        ref = copy.deepcopy(model)
        ref_losses, ref_grads = _single_card_grads(cfg, ref, batches[:2],
                                                   priorities, dev)
        # the time in the default mode, as the timed steps run
        torch.use_deterministic_algorithms(False)
        _, out["single_card_s_per_step"] = _timed(
            lambda: _single_card_grads(cfg, ref, batches[:2], priorities,
                                       dev))
        torch.use_deterministic_algorithms(True, warn_only=True)
        del ref
    dist.barrier()
    solver = Solver(cfg, model, 1)
    step = batched_train_step(cfg, model, solver, mesh)
    gen = rank_generator(0, r, dev)
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    digests, secs = [], []
    for i in range(PAR_DP_STEPS):
        mine = [batches[2 * i + r]]
        pri = [{k: torch.as_tensor(v).to(dev) for k, v in
                priorities[r].items()}] if i == 0 else None
        (total, losses, ok, _, _), sec = _timed(
            lambda: step(mine, gen, pri))
        check(bool(ok), f"data-parallel step {i}: not finite")
        if i == 0:
            torch.use_deterministic_algorithms(False)
            got = {"total": float(total),
                   **{k: float(v) for k, v in losses.items()}}
            if r == 0:
                loss_err = max(abs(got[k] - ref_losses[k]) for k in got)
                rep = _grad_report(grads(model), ref_grads)
                check(loss_err <= 1e-4, f"data-parallel step: losses "
                      f"{got} against one process's {ref_losses}")
                check(rep["worst_share_of_tolerance"] <= 1.0,
                      f"data-parallel step: gradients {rep}")
                out["first_step"] = {"losses": got,
                                     "loss_max_abs_err": loss_err, **rep}
        else:
            secs.append(sec)
        digests.append(_digest(model))
    out.update(launches=_launches(), digests=digests, s_per_step=secs,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    return out


def _edge_rows(t, n_shards):
    """The valid rows of map ``t`` within one x-column of a slab edge
    (x = d * w - 1 or d * w, w = X / n_shards): the rows whose convs read
    halo rows."""
    x = t.coords[:, 0]
    w = t.spatial_size[0] // n_shards
    edge = torch.zeros_like(t.row_valid)
    for d in range(1, n_shards):
        edge |= (x == d * w - 1) | (x == d * w)
    return edge & t.row_valid


def _maps_against(got_maps, want_maps, what, n_shards=2):
    """Global maps gathered from the shards against one card's maps: the
    same coords (else fails), then the worst over the maps of the
    difference over the rows within one column of a slab edge relative
    to those rows' own size (Frobenius norms; these rows alone read the
    halo exchange), the same over every row, and the largest difference
    relative to the largest feature (bf16 features); and the edge rows
    counted."""
    out = {"edge_rel": 0.0, "all_rel": 0.0, "max_of_largest": 0.0,
           "edge_rows": 0}
    for i, (g, w) in enumerate(zip(got_maps, want_maps)):
        gv, wv = g.row_valid, w.row_valid
        check(torch.equal(g.coords[gv], w.coords[wv]),
              f"{what} {i}: the gathered rows differ from one card's")
        diff = g.feats[gv].float() - w.feats[wv].float()
        ref = w.feats[wv].float()
        edge = _edge_rows(w, n_shards)[wv]
        rel = {"edge_rel": (diff[edge].norm(), ref[edge].norm()),
               "all_rel": (diff.norm(), ref.norm()),
               "max_of_largest": (diff.abs().max(), ref.abs().max())}
        for k, (num, den) in rel.items():
            out[k] = max(out[k], float(num) / max(float(den), 1e-30))
        out["edge_rows"] += int(edge.sum())
    return out


# the full-width maps of 2 shards against one card's, by compute dtype:
# the edge rows' and every row's difference relative to their own size
# (see PERF.md)
MAPS_REL_LIMITS = {"bfloat16": 2e-2, "float32": 1e-3}


def _broken_refresh(kind):
    """A HaloExchange.refresh with a planted fault, for the control runs
    of the maps check: ``dropped`` leaves the halo rows zero,
    ``misordered`` writes each halo row from the next site of its
    column."""
    from detection_3d_tpu_torch.parallel.spatial import HaloExchange
    exact = HaloExchange.refresh

    def refresh(self, feats):
        if kind == "misordered":
            feats = exact(self, feats)
        out = feats.clone()
        for idx, ok in ((self.recv_lo, self.recv_lo_ok),
                        (self.recv_hi, self.recv_hi_ok)):
            rows = idx[ok]
            out[rows] = 0 if kind == "dropped" else feats[rows.roll(1)]
        return out
    return refresh


def _maps_check(cfg, model, batch, group, shard_caps, halo_caps):
    """The sharded trunk's gathered maps against one card's (on the
    group's rank 0) in ``cfg``'s compute dtype: the exact exchange within
    MAPS_REL_LIMITS and each planted fault (:func:`_broken_refresh`)
    above it on the edge rows. Returns rank 0's readings by run."""
    import itertools
    import torch.distributed as dist
    from detection_3d_tpu_torch.engine.trainer import batch_to_device
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.models.detector import voxelize_points
    from detection_3d_tpu_torch.parallel import spatial
    limit = MAPS_REL_LIMITS[cfg.compute_dtype]
    first = dist.get_rank(group) == 0
    out = {}
    with torch.no_grad():
        if first:
            dev = next(model.parameters()).device
            (pts, fts, valid), _, _ = batch_to_device(batch, dev)
            table = voxelize_points(cfg, pts, fts, valid)
            table = table.with_feats(
                table.feats.to(getattr(torch, cfg.compute_dtype)))
            single = list(itertools.chain(*model.backbone(
                table, build_pyramid(table, cfg))))
        exact = spatial.HaloExchange.refresh
        for kind in ("exact", "dropped", "misordered"):
            if kind != "exact":
                spatial.HaloExchange.refresh = _broken_refresh(kind)
            try:
                grpn, groi, _ = spatial.spatial_maps(
                    cfg, model, batch, group, shard_caps, halo_caps)
            finally:
                spatial.HaloExchange.refresh = exact
            if not first:
                continue
            got = out[kind] = _maps_against([*grpn, *groi], single,
                                            f"{kind} {cfg.compute_dtype} map")
            if kind == "exact":
                check(max(got["edge_rel"], got["all_rel"]) <= limit,
                      f"spatial maps ({cfg.compute_dtype}) against one "
                      f"card's: {got} (limit {limit})")
            else:
                check(got["edge_rel"] > limit, f"spatial maps "
                      f"({cfg.compute_dtype}): the check passes a {kind} "
                      f"halo ({got}, limit {limit})")
    return out


def _shard_d_books(cfg, spyr):
    """Kernel D on the queries of every conv and deconv book of this
    shard's pyramid: bit exact against multi_match_plain on the card and
    equal to the pyramid's books; CUDA event times of both, summed per
    shard pyramid."""
    from detection_3d_tpu_torch.ops.multi_match import (
        multi_match_cuda, multi_match_plain)
    s3d = cfg.sparse3d
    tables = spyr["tables"]
    sums = {"books": 0, "ms": 0.0, "plain_ms": 0.0, "queries": 0}
    for k in range(1, s3d.num_scales):
        fine, coarse = tables[k - 1], tables[k]
        q, _, qd, _ = multi_match_queries(fine, coarse, s3d.kernels[k - 1],
                                          s3d.strides[k - 1])
        for keys, qs, book in ((fine.keys, q, spyr["down"][k - 1].idx),
                               (coarse.keys, qd, spyr["up"][k - 1].idx)):
            got = multi_match_cuda(keys, qs)
            check(torch.equal(got, multi_match_plain(keys, qs)),
                  f"kernel D on a shard book of scale {k}: differs from "
                  "multi_match_plain")
            check(torch.equal(got.reshape(book.shape), book),
                  f"kernel D: the shard pyramid's book of scale {k}")
            sums["books"] += 1
            sums["queries"] += qs.numel()
            sums["ms"] += time_ms(lambda: multi_match_cuda(keys, qs))
            sums["plain_ms"] += time_ms(lambda: multi_match_plain(keys, qs),
                                        3)
    return sums


def par_sp_rank(cfg, batch, shard_caps, halo_caps, tcfg, tbatch, tpri):
    """Rank job of the spatial check (one building over the ranks'
    x-slabs): rank 0 first serves and trains the building on one card
    (s/building, s/step); then every rank builds its shard pyramid and
    runs the sharded trunk (the bytes the exchanges move a forward; the
    gathered maps held against one card's in bf16 and f32, with planted
    halo faults, :func:`_maps_check`; D's books bit exact and timed),
    spatial_predict (s/building, launches) and a
    spatial train step (s/step, launches), its peak memory; and at the
    small config the detections and gradients against one card."""
    import warnings
    import torch.distributed as dist
    from detection_3d_tpu_torch.engine.solver import Solver
    from detection_3d_tpu_torch.engine.trainer import (
        batch_to_device, total_loss)
    from detection_3d_tpu_torch.models.detector import (
        SparseRCNN, voxelize_points)
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.parallel.checks import detections, grads
    from detection_3d_tpu_torch.parallel.mesh import (
        make_mesh, rank_generator)
    from detection_3d_tpu_torch.parallel.spatial import (
        make_spatial_grad_fn, make_spatial_train_step, spatial_maps,
        spatial_predict)
    warnings.simplefilter("ignore")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(axis="sp", device="cuda")
    dev, r, group = mesh.device, mesh.rank, mesh.group("sp")
    model = SparseRCNN(cfg, seed=0).to(dev)
    out = {"rank": r, "device": str(dev)}
    gen = torch.Generator(device=dev).manual_seed(5)
    if r == 0:
        (pts, fts, valid), gt, gtl = batch_to_device(batch, dev)
        with torch.no_grad():
            model.eval()
            model(voxelize_points(cfg, pts, fts, valid))
            _, out["single_card_s_per_building"] = _timed(
                lambda: model(voxelize_points(cfg, pts, fts, valid)))
        model.train()

        def one_step():
            model.zero_grad(set_to_none=True)
            total_loss(model(voxelize_points(cfg, pts, fts, valid), gt, gtl,
                             generator=gen)).backward()
        one_step()
        _, out["single_card_s_per_step"] = _timed(one_step)
        model.zero_grad(set_to_none=True)
    dist.barrier()
    model.eval()
    with torch.no_grad(), _CommBytes() as comm:
        grpn, groi, spyr = spatial_maps(cfg, model, batch, group,
                                        shard_caps, halo_caps)
        torch.cuda.synchronize()
    out["bytes_received_per_forward"] = comm.bytes
    out["own_rows"] = [int(o.sum()) for o in spyr["own_valid"]]
    out["halo_rows"] = [int(b.halo.recv_lo_ok.sum()
                            + b.halo.recv_hi_ok.sum()) for b in spyr["subm"]]
    check(not bool(spyr["halo_overflow"]), "spatial: halo overflow")
    # the gathered maps against one card's, in bf16 and in f32, each with
    # two planted halo faults that must fail
    out["maps"] = {dt: _maps_check(cfg.replace(compute_dtype=dt), model,
                                   batch, group, shard_caps, halo_caps)
                   for dt in MAPS_REL_LIMITS}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out["d_books"] = _shard_d_books(cfg, spyr)
    del grpn, groi, spyr
    spatial_predict(cfg, mesh, model, batch, shard_caps, halo_caps)
    cuda_lib.reset_launches()
    (det, ovf), out["s_per_building"] = _timed(lambda: spatial_predict(
        cfg, mesh, model, batch, shard_caps, halo_caps))
    out["serve_launches"] = _launches()
    check(not bool(ovf) and bool(det.valid.any()),
          "spatial_predict: overflow or no detections")
    out["detections"] = int(det.valid.sum())
    model.train()
    step = make_spatial_train_step(cfg, mesh, model, Solver(cfg, model, 1),
                                   shard_caps, halo_caps)
    sgen = rank_generator(0, 0, dev)     # every shard draws alike
    step(batch, sgen)
    cuda_lib.reset_launches()
    (total, _, ok, ovf), out["s_per_step"] = _timed(
        lambda: step(batch, sgen))
    out["train_launches"] = _launches()
    check(bool(ok) and not bool(ovf), "spatial train step: not finite or "
          "overflow")
    out["total_loss"] = float(total)
    out["digest"] = _digest(model)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # the small config: detections and gradients against one card
    tmodel = SparseRCNN(tcfg, seed=0).to(dev)
    tdet, _ = spatial_predict(tcfg, mesh, tmodel.eval(), tbatch,
                              SMALL_SHARD_CAPS, SMALL_HALO_CAPS)
    pri = {k: torch.as_tensor(v).to(dev) for k, v in tpri.items()}
    tmodel.train()
    total, _, _, _ = make_spatial_grad_fn(
        tcfg, mesh, tmodel, SMALL_SHARD_CAPS, SMALL_HALO_CAPS)(
            tbatch, priorities=pri)
    if r == 0:
        got = grads(tmodel)
        tmodel.eval()
        with torch.no_grad():
            (pts, fts, valid), _, _ = batch_to_device(tbatch, dev)
            want_det = tmodel(voxelize_points(tcfg, pts, fts, valid))
        tmodel.train()
        ref, ref_grads = _single_card_grads(tcfg, tmodel, [tbatch], [tpri],
                                            dev)
        rep = _grad_report(got, ref_grads)
        check(rep["worst_share_of_tolerance"] <= 1.0 and abs(
            float(total) - ref["total"]) <= 1e-4, f"spatial gradients at "
            f"the small config: {rep}, loss {float(total)} against "
            f"{ref['total']}")
        out["small"] = {"detections": _dets_agree(
            detections(tdet), detections(want_det),
            "spatial_predict at the small config"),
            "loss_max_abs_err": abs(float(total) - ref["total"]), **rep}
    return out


def par_dpsp_rank(cfg, batches, shard_caps, halo_caps, tcfg, tbatches,
                  tpris):
    """Rank job of the dp x sp check (2 x 2 ranks): two full-width
    make_dp_spatial_train_steps over two buildings (the second's
    launches and s/step; the digest after both, peak memory), then at
    the small config the gradient of make_dp_spatial_grad_fn against
    the mean of the two buildings' one-card gradients (rank 0)."""
    import warnings
    from detection_3d_tpu_torch.engine.solver import Solver
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.parallel.checks import grads
    from detection_3d_tpu_torch.parallel.mesh import (
        make_mesh_2d, rank_generator)
    from detection_3d_tpu_torch.parallel.spatial import (
        make_dp_spatial_grad_fn, make_dp_spatial_train_step)
    warnings.simplefilter("ignore")
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh_2d(2, 2, device="cuda")
    dev = mesh.device
    model = SparseRCNN(cfg, seed=0).to(dev).train()
    step = make_dp_spatial_train_step(cfg, mesh, model,
                                      Solver(cfg, model, 1), shard_caps,
                                      halo_caps)
    gen = rank_generator(0, mesh.coord("dp"), dev)
    torch.cuda.reset_peak_memory_stats()
    step(batches, gen)        # warms up, and waits for the slowest rank
    cuda_lib.reset_launches()
    (total, _, ok, ovf), sec = _timed(lambda: step(batches, gen))
    out = {"rank": mesh.rank, "coords": mesh.coords,
           "launches": _launches(), "s_per_step": sec,
           "total_loss": float(total), "digest": _digest(model),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    check(bool(ok) and not bool(ovf), "dp x sp step: not finite or overflow")
    tmodel = SparseRCNN(tcfg, seed=0).to(dev).train()
    pri = [{k: torch.as_tensor(v).to(dev) for k, v in p.items()}
           for p in tpris]
    total, _, _, _ = make_dp_spatial_grad_fn(
        tcfg, mesh, tmodel, SMALL_SHARD_CAPS, SMALL_HALO_CAPS)(
            tbatches, None, pri)
    if mesh.rank == 0:
        got = grads(tmodel)
        ref, ref_grads = _single_card_grads(tcfg, tmodel, tbatches, tpris,
                                            dev)
        rep = _grad_report(got, ref_grads)
        check(rep["worst_share_of_tolerance"] <= 1.0 and abs(
            float(total) - ref["total"]) <= 1e-4, f"dp x sp gradients at "
            f"the small config: {rep}")
        out["small"] = {"loss_max_abs_err": abs(float(total) - ref["total"]),
                        **rep}
    return out


# the kernels each rank must launch: serving a shard, training a shard,
# a data-parallel step (its pyramid takes no book from D)
# the masked BN's launch counters: two forward, two backward
BN_KERNELS = ("masked_bn_stats", "masked_bn_normalise", "masked_bn_dsums",
              "masked_bn_dx")
PAR_KERNELS = ("gather_conv", "subm_match", "rotated_iou", "multi_match"
               ) + BN_KERNELS[:2]
PAR_TRAIN_KERNELS = PAR_KERNELS + ("gather_conv_dfeats", "gather_conv_dw"
                                   ) + BN_KERNELS[2:]
DP_KERNELS = ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
              "subm_match", "rotated_iou") + BN_KERNELS


def parallel_path(cfg, scenes, dev="cuda"):
    """The multi-device phase at full width (full_scale_config(), seeded
    random weights), each part in its own ranks started by
    parallel/mesh.launch after the kernels were built here: data
    parallelism on 2 ranks over 2 * PAR_DP_STEPS buildings
    (:func:`par_dp_rank`), spatial sharding of one building over 2
    x-slabs (:func:`par_sp_rank`) and dp x sp = 2 x 2 over two buildings
    (:func:`par_dpsp_rank`); NCCL over distinct cards where there are as
    many cards as ranks, else gloo with every rank on cuda:0. Fails on a
    rank that fails or a kernel a rank did not launch. Returns every
    rank's launches by path and the spatial D books' sums. ``dev`` is
    where the caps are measured."""
    import shutil
    from detection_3d_tpu_torch.engine.trainer import pad_scene
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.parallel.mesh import launch
    init_dir = cuda_lib.BUILD_DIR / "parallel_init"   # gitignored, removed
    shutil.rmtree(init_dir, ignore_errors=True)
    init_dir.mkdir(parents=True)
    cards = torch.cuda.device_count()
    print(f"parallel phase: {cards} card(s) seen; 2 ranks on "
          f"{_backend(2)}, 4 ranks on {_backend(4)}"
          + ("" if cards >= 2 else " (every rank on cuda:0: the times "
             "measure correctness and overhead, not scaling)"))
    launches = {}

    def run(name, fn, n, args):
        t0 = time.perf_counter()
        res = launch(fn, n, _backend(n), str(init_dir / name), args=args,
                     timeout=PAR_TIMEOUT, cpu_threads=0)
        print(f"parallel {name}: {n} ranks in "
              f"{time.perf_counter() - t0:.1f} s")
        return res

    # data parallelism: 2 ranks, one building each a step
    batches = [pad_scene(cfg, s) for s in scenes[:2 * PAR_DP_STEPS]]
    g = torch.Generator().manual_seed(9)
    shapes = SparseRCNN(cfg).priority_shapes()
    pri = [{k: torch.rand((m,), generator=g).numpy()
            for k, m in shapes.items()} for _ in range(2)]
    dp = run("dp", par_dp_rank, 2, (cfg, batches, pri))
    for r in dp:
        check(r["digests"] == dp[0]["digests"], "data parallelism: the "
              "parameters differ across ranks")
        for k in DP_KERNELS:
            check(r["launches"][k] > 0, f"data parallelism: rank "
                  f"{r['rank']} did not launch {k}")
        launches[f"dp_train_rank{r['rank']}"] = r["launches"]
    print("parallel dp: " + json.dumps(
        {"first_step_against_one_process": dp[0]["first_step"],
         "single_card_s_per_step_2_buildings":
             dp[0]["single_card_s_per_step"],
         "s_per_step_by_rank": [r["s_per_step"] for r in dp],
         "peak_gib_by_rank": [r["peak_gib"] for r in dp],
         "launches_by_rank": [r["launches"] for r in dp],
         "param_digests_equal_every_step": True}))

    # spatial sharding: one building over 2 x-slabs; dp x sp: two
    sp_batches = [pad_scene(cfg, centered(s, cfg)) for s in scenes[:2]]
    cfg, shard_caps, halo_caps, measured = measure_caps(cfg, sp_batches, 2,
                                                        dev)
    print("parallel caps (2 x-slabs, from the single-card pyramids of the "
          "two buildings; voxels and shard rows x 1.10 rounded up to 256, "
          "halo x 1.25 rounded up to 32): " + json.dumps(
              {"shard_caps": shard_caps, "halo_caps": halo_caps,
               **measured}))
    tcfg = tiny_spatial_config()
    tbatches = [pad_scene(tcfg, tiny_scene(tcfg, s)) for s in (0, 1)]
    tshapes = SparseRCNN(tcfg).priority_shapes()
    tpri = [{k: torch.rand((m,), generator=g).numpy()
             for k, m in tshapes.items()} for _ in range(2)]
    sp = run("sp", par_sp_rank, 2, (cfg, sp_batches[0], shard_caps,
                                    halo_caps, tcfg, tbatches[0], tpri[0]))
    for r in sp:
        check(r["digest"] == sp[0]["digest"], "spatial step: the "
              "parameters differ across shards")
        for path, kernels in (("serve", PAR_KERNELS),
                              ("train", PAR_TRAIN_KERNELS)):
            counts = r[f"{path}_launches"]
            for k in kernels:
                check(counts[k] > 0, f"spatial {path}: rank {r['rank']} "
                      f"did not launch {k}")
            launches[f"sp_{path}_rank{r['rank']}"] = counts
    print("parallel sp: " + json.dumps({
        k: [r.get(k) for r in sp] for k in (
            "own_rows", "halo_rows", "bytes_received_per_forward",
            "d_books", "s_per_building", "s_per_step", "peak_gib",
            "serve_launches", "train_launches", "detections",
            "total_loss")}))
    print("parallel sp against one card: " + json.dumps({
        "maps": sp[0]["maps"], "maps_rel_limits": MAPS_REL_LIMITS,
        "single_card_s_per_building": sp[0]["single_card_s_per_building"],
        "single_card_s_per_step": sp[0]["single_card_s_per_step"],
        "small_config": sp[0]["small"]}))
    dpsp = run("dpsp", par_dpsp_rank, 4, (cfg, sp_batches, shard_caps,
                                          halo_caps, tcfg, tbatches, tpri))
    for r in dpsp:
        check(r["digest"] == dpsp[0]["digest"], "dp x sp: the parameters "
              "differ across ranks")
        for k in PAR_TRAIN_KERNELS:
            check(r["launches"][k] > 0, f"dp x sp: rank {r['rank']} did "
                  f"not launch {k}")
        launches[f"dpsp_train_rank{r['rank']}"] = r["launches"]
    print("parallel dp x sp: " + json.dumps({
        "s_per_step_by_rank": [r["s_per_step"] for r in dpsp],
        "peak_gib_by_rank": [r["peak_gib"] for r in dpsp],
        "total_loss": dpsp[0]["total_loss"],
        "small_config_against_one_card": dpsp[0]["small"]}))
    shutil.rmtree(init_dir, ignore_errors=True)
    return launches, sp[0]["d_books"]



# ---- the generic sparse networks and dataset preparation ----------------

# SparseConvNet's ScanNet UNet (examples/ScanNet/unet.py: UNet(3,
# block_reps, [m, 2m, ..., 7m], residual_blocks)) at its largest
# documented setting, m = 32, block_reps = 2, residual blocks
ZOO_PLANES = (32, 64, 96, 128, 160, 192, 224)
ZOO_REPS = 2
ZOO_CAP_MARGIN = 1.10    # a level's cap over its measured voxel count
ZOO_KERNELS = ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
               "subm_match")


def zoo_vgg_layers(planes):
    """SparseVGG over the zoo's levels: two 3^3 convs a level, then a max
    pool (from even levels) or a strided conv (from odd ones) down to the
    next, and two convs at the deepest."""
    layers = []
    for k, c in enumerate(planes):
        layers += [("C", c), ("C", c)]
        if k < len(planes) - 1:
            layers.append(("MP",) if k % 2 == 0 else ("C3/2", planes[k + 1]))
    return tuple(layers)


def zoo_caps(table0, n_levels):
    """plan_levels caps over ``table0`` that hold every voxel: each
    level's count under caps of table0's capacity (which must hold them),
    x ZOO_CAP_MARGIN, rounded up to 256; level 0 is table0. Returns
    (caps, counts)."""
    from detection_3d_tpu_torch.models.factories import plan_levels
    with torch.no_grad():
        big = plan_levels(table0, (table0.capacity,) * n_levels)
    counts = []
    for k, t in enumerate(big["tables"]):
        check(int(t.true_num) <= t.capacity, f"zoo level {k}: "
              f"{int(t.true_num)} voxels over {t.capacity}")
        counts.append(int(t.true_num))
    caps = (table0.capacity,) + tuple(
        _round_up(ZOO_CAP_MARGIN * c, 256) for c in counts[1:])
    return caps, counts


def zoo_kernel_shapes(plan, dev, gen):
    """Kernels A and A' at the UNet's level-0 (32 -> 32) and deepest
    (224 -> 224) submanifold convs, bf16 as the net runs, on the plan's
    book, row order and BackwardBook, against gather_conv and
    gather_conv_backward: within 1e-2 of the largest wanted value (one
    bf16 rounding of f32 sums), timed by CUDA events beside the plain
    versions, with conv_bound / bwd_bound. Returns the lines."""
    from detection_3d_tpu_torch.ops.sparse_conv import (
        gather_conv, gather_conv_backward, gather_conv_cuda,
        gather_conv_dfeats_cuda, gather_conv_dw_cuda)
    lines = []
    last = len(ZOO_PLANES) - 1
    for lvl in (0, last):
        c = ZOO_PLANES[lvl]
        t = plan["tables"][lvl]
        idx, order, book, _ = plan["subm"][lvl]
        valid = t.row_valid
        feats = (torch.randn((t.capacity, c), generator=gen, device=dev)
                 * valid[:, None]).to(torch.bfloat16)
        w = (torch.randn((27, c, c), generator=gen, device=dev)
             * (2.0 / (27 * c)) ** 0.5).to(torch.bfloat16)
        g = torch.randn((t.capacity, c), generator=gen,
                        device=dev).to(torch.bfloat16)
        want_f, want_w = gather_conv_backward(feats, idx, w, valid, g)
        runs = {"A": (lambda: gather_conv_cuda(feats, idx, w, valid, order),
                      gather_conv(feats, idx, w, valid), 1.0),
                "dfeats": (lambda: gather_conv_dfeats_cuda(g, w, book),
                           want_f, 1e-30),
                "dw": (lambda: gather_conv_dw_cuda(feats, g, book), want_w,
                       1e-30)}
        a_ms, a_by, nnz = conv_bound(feats, idx, w, valid)
        b_bounds, _ = bwd_bound(feats, idx, w, valid)
        plain = {"A": time_ms(lambda: gather_conv(feats, idx, w, valid), 3)}
        plain["dfeats"] = plain["dw"] = time_ms(
            lambda: gather_conv_backward(feats, idx, w, valid, g), 3)
        for part, (fn, want, floor) in runs.items():
            want = want.float()
            err = float((fn().float() - want).abs().max())
            tol = 1e-2 * max(float(want.abs().max()), floor)
            check(err <= tol, f"zoo kernel {part} level {lvl}: max abs err "
                  f"{err} > {tol}")
            b_ms, b_by = (a_ms, a_by) if part == "A" else b_bounds[part]
            line = {"part": part, "level": lvl, "case": f"subm {c}->{c}",
                    "dtype": "bfloat16", "V": t.capacity,
                    "rows": int(t.num), "nnz": nnz, "max_abs_err": err,
                    "tolerance": tol, "ms": time_ms(fn),
                    "plain_ms": plain[part],
                    "plain_computes": ("gather_conv" if part == "A" else
                                       "gather_conv_backward, both parts"),
                    "bound_ms": b_ms, "bound_by": b_by}
            print("zoo kernel", json.dumps(line))
            lines.append(line)
    return lines


def small_zoo_card_vs_cpu(card="cuda", what="small zoo"):
    """plan_levels, a residual SparseUNet (leakiness 0.1) and a SparseVGG
    (C, MP, C3/2) on a small random table, on the CPU (plain versions) and
    on the card (kernels), same weights, f32: every table and book bit
    equal; outputs within 1e-4 of the largest (at least 1); each
    gradient within 1e-3 of its largest entry + 1e-5 (as the tiny
    training step)."""
    import copy
    from detection_3d_tpu_torch.models.factories import (
        SparseUNet, SparseVGG, plan_levels)
    from detection_3d_tpu_torch.ops.sparse import build_sparse_tensor
    rng = np.random.RandomState(0)
    spatial, n = (64, 48, 32), 3000
    coords = np.c_[rng.randint(0, 64, n), rng.randint(0, 48, n),
                   rng.randint(0, 32, n), np.zeros(n)].astype(np.int32)
    feats = rng.randn(n, 4).astype(np.float32)
    caps = (4096, 2048, 1024, 512)
    nets = {"unet": SparseUNet(4, (8, 16, 24, 32), reps=2, residual=True,
                               leakiness=0.1, seed=1),
            "vgg": SparseVGG(4, (("C", 8), ("C", 8), ("MP",), ("C", 16),
                                 ("C3/2", 24), ("C", 24)), seed=2)}
    res = {}
    for d in ("cpu", card):
        table = build_sparse_tensor(
            torch.from_numpy(coords).to(d), torch.from_numpy(feats).to(d),
            None, spatial, 1, caps[0])
        plan = plan_levels(table, caps, backward=True)
        outs = {}
        for name, base in nets.items():
            net = copy.deepcopy(base).to(d)
            out = net(plan)
            out = out[0] if isinstance(out, tuple) else out
            out.square().sum().backward()
            outs[name] = (out.detach().cpu(),
                          {k: p.grad.cpu() for k, p in
                           net.named_parameters()})
        res[d] = (plan, outs)
    (p_cpu, o_cpu), (p_gpu, o_gpu) = res["cpu"], res[card]
    for key in ("subm", "down", "up"):
        for k, (a, b) in enumerate(zip(p_cpu[key], p_gpu[key])):
            check(torch.equal(a.idx, b.idx.cpu()), f"{what}: {key}[{k}] "
                  "differs card vs CPU")
    report = {}
    for name in nets:
        (want, g_want), (got, g_got) = o_cpu[name], o_gpu[name]
        err = float((got - want).abs().max())
        tol = 1e-4 * max(float(want.abs().max()), 1.0)
        check(err <= tol, f"{what} {name}: output max abs err {err} > {tol}")
        worst = 0.0
        for k, gw in g_want.items():
            gerr = float((g_got[k] - gw).abs().max())
            gtol = 1e-3 * float(gw.abs().max()) + 1e-5
            check(gerr <= gtol, f"{what} {name}: gradient {k} max abs err "
                  f"{gerr} > {gtol}")
            worst = max(worst, gerr / gtol)
        report[name] = {"max_abs_err": err, "tolerance": tol,
                        "gradients": len(g_want),
                        "worst_gradient_share_of_tolerance": worst}
    print(f"{what}: books bit equal, card vs CPU " + json.dumps(report))
    return report


def zoo_path(cfg, scene, dev, gen):
    """SparseUNet(32..224, reps 2, residual) over plan_levels of one
    full-size building at full_scale_config()'s grid, with caps measured
    to hold every voxel (:func:`zoo_caps`): the plan (B for every
    submanifold book), a bf16 forward and the backward of (out ** 2).sum()
    (A and A'), twice, counts set to 0 before the first and read after
    it; finite outputs and gradients. Then SparseVGG
    (:func:`zoo_vgg_layers`) and FullyConvolutionalNet (the same widths,
    reps 2) forward on the same plan, each counted alone; A and A' at the
    UNet's level-0 and deepest shapes (:func:`zoo_kernel_shapes`); and the
    small nets card against CPU (:func:`small_zoo_card_vs_cpu`). Returns
    ({path: launches}, kernel lines)."""
    from detection_3d_tpu_torch.engine.trainer import (
        batch_to_device, pad_scene)
    from detection_3d_tpu_torch.models.detector import voxelize_points
    from detection_3d_tpu_torch.models.factories import (
        FullyConvolutionalNet, SparseUNet, SparseVGG, plan_levels)
    from detection_3d_tpu_torch.ops import cuda_lib
    n = len(ZOO_PLANES)
    (pts, fts, valid), _, _ = batch_to_device(pad_scene(cfg, scene), dev)
    with torch.no_grad():
        table0 = voxelize_points(cfg, pts, fts, valid)
    check(int(table0.true_num) <= table0.capacity, "zoo: level 0 subsampled")
    caps, counts = zoo_caps(table0, n)
    print(f"zoo caps: voxels per level {counts}, caps (x {ZOO_CAP_MARGIN}, "
          f"rounded up to 256; level 0 the scale-0 table) {list(caps)}")
    unet = SparseUNet(cfg.in_channels, ZOO_PLANES, reps=ZOO_REPS,
                      residual=True, seed=0).to(dev)
    feats = table0.feats.to(torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rounds, launches = [], {}
    for r in range(2):
        if r == 0:
            cuda_lib.reset_launches()
        t0 = time.perf_counter()
        plan = plan_levels(table0, caps, backward=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = unet(plan, feats)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        unet.zero_grad(set_to_none=True)
        out.float().square().sum().backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if r == 0:
            launches["zoo"] = dict(cuda_lib.launches)
        rounds.append({"plan_s": t1 - t0, "forward_s": t2 - t1,
                       "backward_s": t3 - t2})
        check(out.shape == (caps[0], ZOO_PLANES[0])
              and bool(torch.isfinite(out).all()), "zoo: UNet output")
        for k, p in unet.named_parameters():
            check(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                  f"zoo: UNet gradient {k}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ZOO_KERNELS:
        check(launches["zoo"][name] > 0, f"kernel {name} was not launched "
              "on the zoo path")
    nparams = sum(p.numel() for p in unet.parameters())
    print("zoo UNet: " + json.dumps({
        "nplanes": ZOO_PLANES, "reps": ZOO_REPS, "residual": True,
        "parameters": nparams, "level_rows": [int(t.num) for t in
                                              plan["tables"]],
        "rounds": rounds, "peak_device_memory_gib": peak,
        "launches": launches["zoo"]}))
    print(f"zoo UNet: forward {rounds[1]['forward_s']:.4f} s, backward "
          f"{rounds[1]['backward_s']:.4f} s, plan {rounds[1]['plan_s']:.4f} "
          f"s (second round; host clock, synchronised; bf16), peak "
          f"{peak:.2f} GiB")
    del unet, out
    layers = zoo_vgg_layers(ZOO_PLANES)
    for name, net in (("zoo_vgg", SparseVGG(cfg.in_channels, layers, seed=0)),
                      ("zoo_fcn", FullyConvolutionalNet(
                          cfg.in_channels, ZOO_PLANES, reps=ZOO_REPS,
                          seed=0))):
        net = net.to(dev)
        with torch.no_grad():
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            h = net(plan, feats)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            launches[name] = dict(cuda_lib.launches)
        if name == "zoo_vgg":
            h, lvl = h
            check(lvl == n - 1 and h.shape == (caps[-1], ZOO_PLANES[-1]),
                  "zoo: VGG output level and shape")
        else:
            check(h.shape == (caps[0], sum(ZOO_PLANES)), "zoo: FCN shape")
        check(bool(torch.isfinite(h).all()), f"{name}: non-finite output")
        check(launches[name]["gather_conv"] > 0, f"kernel A was not "
              f"launched on {name}")
        print(f"{name}: forward {sec:.4f} s (host clock, synchronised, "
              f"bf16, first call), output {tuple(h.shape)}, launches "
              f"{json.dumps(launches[name])}")
        del net, h
    lines = zoo_kernel_shapes(plan, dev, gen)
    small_zoo_card_vs_cpu(dev)
    return launches, lines


DATAPREP_ROOMS = (5, 5)      # synthetic_multiroom's 5 x 5 rooms of 8 m
DATAPREP_POINTS = 500_000


def dataprep_path(cfg, dev):
    """A SUNCG-format house (tests/torch_house_cases.py: house.json and
    room OBJ meshes of walls, ceilings and floors, door and window nodes;
    DATAPREP_ROOMS rooms of 8 m) through parse_house_file,
    refine_house_boxes and house_point_cloud(method="render",
    num_points=500k), written as a reference-format .pth (xyz, zero
    colour and normal columns: the renderer yields xyz only) and read
    back through SUNCGDataset, then one full-width Trainer step on the
    card. Prints each stage's host seconds, box counts by class and the
    point count. Returns the step's launches."""
    import shutil
    from detection_3d_tpu_torch.data.house_parser import (
        house_point_cloud, parse_house_file, refine_house_boxes)
    from detection_3d_tpu_torch.data.suncg import SUNCGDataset
    from detection_3d_tpu_torch.engine.trainer import Trainer, pad_scene
    from detection_3d_tpu_torch.ops import cuda_lib
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from torch_house_cases import write_house      # shared with the tests
    root = cuda_lib.BUILD_DIR / "dataprep_smoke"   # gitignored, removed
    shutil.rmtree(root, ignore_errors=True)
    secs = {}
    t0 = time.perf_counter()
    path, classes = write_house(str(root / "suncg"), rooms_xy=DATAPREP_ROOMS,
                                room=8.0)
    secs["write_house"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    raw = parse_house_file(path, classes, refine=False)
    secs["parse"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    boxes = refine_house_boxes(raw, level_num=1)
    secs["refine"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pts = house_point_cloud(boxes, num_points=DATAPREP_POINTS,
                            method="render")
    secs["render"] = time.perf_counter() - t0
    check(pts.shape == (DATAPREP_POINTS, 3)
          and bool(np.isfinite(pts).all()), f"dataprep: {pts.shape} points")
    names = cfg.ordered_class_names()[1:]
    kept = {n: boxes[n].astype(np.float32) for n in names if n in boxes}
    for n in names:
        check(kept.get(n, np.zeros((0, 7))).shape[0] > 0,
              f"dataprep: no {n} box")
    t0 = time.perf_counter()
    data = root / "data"
    (data / "houses" / "house_0").mkdir(parents=True)
    pcl = np.c_[pts, np.zeros((pts.shape[0], 6))].astype(np.float32)
    torch.save((pcl, kept), data / "houses" / "house_0" / "0.pth")
    (data / "train_test_splited").mkdir()
    (data / "train_test_splited" / "train.txt").write_text("house_0\n")
    ds = SUNCGDataset("train", cfg, data_root=str(data))
    scene = ds[0]
    secs["write_and_read_pth"] = time.perf_counter() - t0
    n_gt = sum(b.shape[0] for b in kept.values())
    check(len(ds) == 1 and scene["points"].shape[0] == DATAPREP_POINTS
          and scene["gt_labels"].shape[0] == n_gt, "dataprep: read-back")
    trainer = Trainer(cfg, output_dir=str(root / "train"), device=dev)
    state = trainer.init_state(seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = pad_scene(cfg, scene)
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    total, losses, ok, true_num = trainer.step(state, batch, gen)
    secs["train_step"] = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    check(bool(ok) and np.isfinite(total) and true_num > 0,
          f"dataprep: training step not applied ({total}, {losses})")
    for name in ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
                 "subm_match", "rotated_iou"):
        check(launches[name] > 0, f"kernel {name} was not launched on the "
              "dataprep training step")
    print("dataprep: " + json.dumps({
        "rooms": DATAPREP_ROOMS, "host_seconds": secs,
        "raw_boxes": {k: int(v.shape[0]) for k, v in raw.items()},
        "refined_boxes": {k: int(v.shape[0]) for k, v in boxes.items()},
        "points": int(pts.shape[0]), "gt_boxes_read": n_gt,
        "true_num": int(true_num), "loss": float(total), "losses": losses,
        "launches": launches}))
    del trainer, state
    shutil.rmtree(root, ignore_errors=True)
    return launches


API_NMS_BOXES = 2000


def api_path(cfg, scene, dev):
    """The JAX package's names of two searches: rotate_nms_3d on 2000
    NMS-like boxes (kernel C) with the keep set of nms_boxes on the card
    and of its plain version on the CPU; conv_rulebook and
    deconv_rulebook (kernel D) on the building's scale-0 and scale-1
    tables, bit equal to downsample_with_rulebooks' scatter books. Counts
    set to 0 before each and read after. Returns {path: launches}."""
    from detection_3d_tpu_torch.engine.trainer import (
        batch_to_device, pad_scene)
    from detection_3d_tpu_torch.models.detector import voxelize_points
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.ops.nms import nms_boxes, rotate_nms_3d
    from detection_3d_tpu_torch.ops.sparse import (
        conv_rulebook, downsample_with_rulebooks)
    from detection_3d_tpu_torch.ops.sparse_conv import deconv_rulebook
    launches = {}
    rng = np.random.RandomState(3)
    host = (torch.from_numpy(_nms_boxes_np(API_NMS_BOXES, 3)),
            torch.from_numpy(rng.rand(API_NMS_BOXES).astype(np.float32)),
            torch.from_numpy(rng.rand(API_NMS_BOXES) > 0.05))
    card = [x.to(dev) for x in host]
    cuda_lib.reset_launches()
    keep, count = rotate_nms_3d(*card, 0.3, API_NMS_BOXES)
    torch.cuda.synchronize()
    launches["api_nms"] = dict(cuda_lib.launches)
    check(launches["api_nms"]["rotated_iou"] == 1, "rotate_nms_3d: kernel C "
          "launch count")
    k_card, _ = nms_boxes(*card, 0.3, API_NMS_BOXES)
    k_cpu, c_cpu = nms_boxes(*host, 0.3, API_NMS_BOXES)
    check(torch.equal(keep, k_card) and torch.equal(keep.cpu(), k_cpu)
          and int(count) == int(c_cpu) > 0, "rotate_nms_3d: keep sets differ")
    print(f"rotate_nms_3d: {API_NMS_BOXES} boxes, {int(count)} kept, keep "
          f"set equal to nms_boxes on the card and on the CPU, launches "
          f"{json.dumps(launches['api_nms'])}")
    s3d = cfg.sparse3d
    k, s = s3d.kernels[0], s3d.strides[0]
    with torch.no_grad():
        (pts, fts, valid), _, _ = batch_to_device(pad_scene(cfg, scene), dev)
        t0 = voxelize_points(cfg, pts, fts, valid)
        cap1 = cfg.caps.scale_caps(s3d.num_scales, base=t0.capacity)[1]
        t1, crb, drb = downsample_with_rulebooks(t0, k, s, cap1)
        cuda_lib.reset_launches()
        conv = conv_rulebook(t1, t0, k, s)
        dec = deconv_rulebook(t0, t1, k, s)
        torch.cuda.synchronize()
        launches["api_books"] = dict(cuda_lib.launches)
    check(launches["api_books"]["multi_match"] == 2, "conv_rulebook / "
          "deconv_rulebook: kernel D launch count")
    check(torch.equal(conv, crb) and torch.equal(dec, drb),
          "conv_rulebook / deconv_rulebook differ from the scatter books")
    print(f"conv_rulebook {tuple(conv.shape)} and deconv_rulebook "
          f"{tuple(dec.shape)} of scales 0 -> 1 bit equal to the scatter "
          f"books, launches {json.dumps(launches['api_books'])}")
    return launches


TOOLS_BUILDINGS = 4      # the bench twin's stream (a held-out one warms up)
TOOLS_NEAR_THRESHOLD = 1e-5   # a gt this near fg_iou_threshold may flip
TOOLS_PROFILE_ROUNDS = 15     # profile_inference's rounds (medians)


def _finite_positive(x):
    return isinstance(x, (int, float)) and bool(np.isfinite(x)) and x > 0


def _share(x):
    return isinstance(x, float) and 0.0 <= x <= 1.0


def _diag_card_vs_cpu(gcfg, scene, dev, pc_card, pc_cpu):
    """The per-class counts of diag_anchor_coverage on the card and on
    the CPU must be equal; where they are not, every gt whose status
    differs must have a best quality within TOOLS_NEAR_THRESHOLD of
    fg_iou_threshold, and is named and excepted. Returns the excepted
    gts."""
    from detection_3d_tpu_torch.tools.diag_anchor_coverage import (
        scene_coverage)
    keys = ("n_gt", "covered", "rescued")
    if all(pc_card[c][k] == pc_cpu[c][k] for c in pc_card for k in keys):
        return []
    thr = gcfg.rpn.fg_iou_threshold
    card_rows, _ = scene_coverage(gcfg, scene, dev)
    cpu_rows, _ = scene_coverage(gcfg, scene, "cpu")
    excepted = []
    for g, (a, b) in enumerate(zip(card_rows, cpu_rows)):
        if ((a["above"] > 0, a["assigned"] > 0)
                == (b["above"] > 0, b["assigned"] > 0)):
            continue
        near = min(abs(a["best"] - thr), abs(b["best"] - thr))
        check(near <= TOOLS_NEAR_THRESHOLD, f"diag_anchor_coverage: gt {g} "
              f"({a['class']}) covered differently on the card ({a}) and "
              f"on the CPU ({b}), {near} from the threshold")
        excepted.append({"gt": g, "class": a["class"], "card": a, "cpu": b})
    print("diag_anchor_coverage: excepted near the threshold: "
          + json.dumps(excepted))
    return excepted


def tools_path(cfg, scenes, dev):
    """Phase 6f: the repo-level tools' twins (detection_3d_tpu_torch/
    tools/) on the card, on buildings generated before.

    The bench twin (tools/bench.run) at full width: the host pack and the
    device time of scenes[0], its stream over the next TOOLS_BUILDINGS
    in table and pyramid mode and at batch 2; the JSON line it builds,
    parsed back, must hold every key of bench.py's line and the twin's
    own, finite positive times, the card's name, an idle share in [0, 1]
    and detections for every building. The twin sets the launch counts
    to 0 before each timed run and reads them after (bench_table,
    bench_pyramid, bench_batch). Its parity checks (bench.parity) on
    scenes[0] (bench_parity). train_bench at gen_config() on a 35k-point
    varied building, 3 steps (train_bench); profile_inference at full
    width, TOOLS_PROFILE_ROUNDS rounds (profile_inference): positive
    prefix and stage times, the full prefix's detections within 1e-6 of
    make_predict_fn's;
    diag_anchor_coverage.coverage on seed 0 at gen_config() on the card
    (diag) and on the CPU, the per-class counts equal but for gts within
    TOOLS_NEAR_THRESHOLD of fg_iou_threshold, which are named; and
    clean_models over a directory of model_*.pt files. Counts set to 0
    before each path and read after. Returns {path: launches}."""
    import shutil
    from detection_3d_tpu_torch.data.synthetic import (
        synthetic_varied_building)
    from detection_3d_tpu_torch.engine.inference import (
        make_predict_fn, pad_scene)
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.tools import (
        bench, clean_models, diag_anchor_coverage, profile_inference,
        train_bench)
    from detection_3d_tpu_torch.tools.generalization_check import gen_config
    launches = {}
    name = torch.cuda.get_device_name(0)
    model = SparseRCNN(cfg, seed=0)

    # ---- the bench twin: stream and batch, then parity -----------------
    t0 = time.perf_counter()
    line, streamed = bench.run(cfg, model, scenes[0],
                               scenes[1:1 + TOOLS_BUILDINGS], dev,
                               batch_sizes=(2,))
    line = json.loads(json.dumps(line))
    print(f"bench twin ({time.perf_counter() - t0:.1f} s):", json.dumps(line))
    for key in bench.LINE_KEYS + bench.EXTRA_KEYS:
        check(key in line, f"bench twin: key {key} missing")
    for key in ("value", "vs_baseline", "device_s", "stream_table_s",
                "stream_pyramid_s", "stream_wait_pack_s",
                "stream_dispatch_s", "stream_drain_fetch_s",
                "host_pack_pyramid_s", "batch_throughput_bps", "peak_gib",
                "power_limit_w"):
        check(_finite_positive(line[key]), f"bench twin: {key} = "
              f"{line[key]}")
    check(line["device"] == name, f"bench twin: device {line['device']}")
    check(_share(line["idle_share"]),
          f"bench twin: idle share {line['idle_share']}")
    check(line["n_buildings"] == TOOLS_BUILDINGS, "bench twin: buildings")
    for run, preds in streamed["preds"].items():
        check(len(preds) == TOOLS_BUILDINGS and all(
            p["boxes"].shape[0] > 0 and np.isfinite(p["boxes"]).all()
            for p in preds), f"bench twin {run}: missing or non-finite "
              "detections")
    for path, run in (("bench_table", "table"), ("bench_pyramid", "pyramid"),
                      ("bench_batch", "batch_2")):
        ln = launches[path] = streamed["launches"][run]
        check(ln["gather_conv"] > 0 and ln["rotated_iou"] > 0,
              f"{path}: kernel A or C was not launched")
        check((ln["subm_match"] > 0) == (run != "pyramid"),
              f"{path}: kernel B launches {ln['subm_match']}")
    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    failures = bench.parity(cfg, scenes[0], dev)
    torch.cuda.synchronize()
    launches["bench_parity"] = dict(cuda_lib.launches)
    check(not failures, f"bench twin --parity: {failures}")
    for k in ("gather_conv", "subm_match", "multi_match"):
        check(launches["bench_parity"][k] > 0, f"bench_parity: kernel {k} "
              "was not launched")
    print(f"bench twin --parity ({time.perf_counter() - t0:.1f} s): "
          f"{json.dumps({'parity': 'OK'})}, launches "
          f"{json.dumps(launches['bench_parity'])}")

    # ---- train_bench at gen_config() -----------------------------------
    gcfg = gen_config()
    gscene = synthetic_varied_building(
        seed=0, num_points=35_000, classes=gcfg.classes,
        voxel_scale=gcfg.sparse3d.voxel_scale)
    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    r = train_bench.run(gcfg, gscene, dev, iters=1)
    launches["train_bench"] = dict(cuda_lib.launches)
    for k in ("gather_conv", "gather_conv_dfeats", "gather_conv_dw",
              "subm_match", "rotated_iou"):
        check(launches["train_bench"][k] > 0, f"train_bench: kernel {k} "
              "was not launched")
    check(all(np.isfinite(r["losses"])) and r["first_ok"],
          f"train_bench: losses {r['losses']}")
    check(_finite_positive(r["device_s_per_step"])
          and _share(r["idle_share"]), "train_bench: device fields")
    print(f"train_bench gen ({time.perf_counter() - t0:.1f} s): "
          + json.dumps({**r, "launches": launches["train_bench"]}))

    # ---- profile_inference at full width -------------------------------
    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    rows, outs = profile_inference.profile(cfg, model, scenes[0], dev,
                                           iters=TOOLS_PROFILE_ROUNDS)
    launches["profile_inference"] = dict(cuda_lib.launches)
    for row in rows:
        check(row["s"] > 0 and row["stage_s"] > 0,
              f"profile_inference: stage {row}")
        check(_finite_positive(row["busy_ms"]) and _share(row["idle_share"]),
              f"profile_inference: device fields {row}")
    with torch.inference_mode():
        want, _ = make_predict_fn(cfg, model, dev)(pad_scene(cfg, scenes[0]))
    d, off = _rows_close(valid_rows(outs["full"][0]), valid_rows(want), 1e-6)
    check(off == 0, f"profile_inference: the full prefix differs from "
          f"make_predict_fn by {d} in {off} detections")
    for k in ("gather_conv", "subm_match", "rotated_iou"):
        check(launches["profile_inference"][k] > 0, f"profile_inference: "
              f"kernel {k} was not launched")
    print(f"profile_inference ({time.perf_counter() - t0:.1f} s): "
          + json.dumps({"stages": rows, "full_vs_predict_max_abs": d,
                        "launches": launches["profile_inference"]}))

    # ---- diag_anchor_coverage on the card and on the CPU ---------------
    t0 = time.perf_counter()
    cuda_lib.reset_launches()
    pc_card = diag_anchor_coverage.coverage(gcfg, [gscene], dev)
    launches["diag"] = dict(cuda_lib.launches)
    t_card = time.perf_counter() - t0
    check(launches["diag"]["rotated_iou"] > 0, "diag: kernel C was not "
          "launched")
    t0 = time.perf_counter()
    pc_cpu = diag_anchor_coverage.coverage(gcfg, [gscene], "cpu")
    t_cpu = time.perf_counter() - t0
    excepted = _diag_card_vs_cpu(gcfg, gscene, dev, pc_card, pc_cpu)
    best_diff = max(float(np.abs(np.subtract(pc_card[c]["best"],
                                             pc_cpu[c]["best"])).max(
                                                 initial=0.0))
                    for c in pc_card)
    print("diag_anchor_coverage seed 0: " + json.dumps(
        {"card": {c: {k: v for k, v in st.items() if k != "best"}
                  for c, st in pc_card.items()},
         "excepted": len(excepted), "best_max_abs_card_vs_cpu": best_diff,
         "card_s": t_card, "cpu_s": t_cpu, "launches": launches["diag"]}))

    # ---- clean_models over model_*.pt files ----------------------------
    root = cuda_lib.BUILD_DIR / "clean_models_smoke"     # gitignored, removed
    run_dir = root / "run_a"
    run_dir.mkdir(parents=True, exist_ok=True)
    for stem in ("model_0000100", "model_0000200", "model_0000300",
                 "model_final", "model_min_loss"):
        torch.save({"step": stem}, run_dir / f"{stem}.pt")
    (run_dir / "last_checkpoint").write_text("model_0000200.pt")
    (run_dir / "log.txt").write_text("log\n")
    check(clean_models.main([str(root / "run_*")]) == 0, "clean_models")
    left = sorted(p.name for p in run_dir.iterdir())
    shutil.rmtree(root, ignore_errors=True)
    check(left == ["_log.txt", "last_checkpoint", "log.txt",
                   "model_0000200.pt", "model_final.pt",
                   "model_min_loss.pt"], f"clean_models left {left}")
    print(f"clean_models: kept {json.dumps(left)}")
    del model
    return launches


BATCH_BUILDINGS = 8      # the batched-serving phase's buildings
BATCH_SIZES = (1, 2, 4)
# every unit's launches in table mode at full_scale_config, whatever B:
# A for the 38 convs of the forward, B for its 9 scales, C and E for the
# RPN's NMS and the ROI postprocess's (one batch each)
UNIT_LAUNCHES = {"gather_conv": 38, "subm_match": 9, "rotated_iou": 2,
                 "greedy_nms": 2}
UNIT_SET_TOL = 1e-4      # a unit's detections against per-building ones


def _capture(module, name, fn):
    """Runs ``fn`` with ``module.name`` wrapped to keep the positional
    arguments of each call; returns them."""
    calls, orig = [], getattr(module, name)

    def recorder(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    setattr(module, name, recorder)
    try:
        fn()
    finally:
        setattr(module, name, orig)
    return calls


def _set_err(got, want):
    """Max abs err of two (K, 10) detection sets (valid rows sorted by
    label, score), or inf when their sizes or labels differ."""
    a, b = (valid_rows(torch.as_tensor(x)) for x in (got, want))
    if a.shape != b.shape or not np.array_equal(a[:, 8], b[:, 8]):
        return float("inf")
    return float(np.abs(a[:, :8] - b[:, :8]).max(initial=0.0))


def _unit_syncs(fn):
    """The host syncs ``fn`` makes: torch's sync debug mode in "warn",
    each as the innermost "file:line" of this repository on the stack."""
    import traceback
    import warnings
    root = str(Path(__file__).resolve().parent) + "/"
    seen = []

    def show(message, *args, **kw):
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            here = [f"{f.filename[len(root):]}:{f.lineno}" for f in stack
                    if f.filename.startswith(root)
                    and not f.filename.endswith("chip_smoke.py")]
            seen.append(here[-1] if here else "outside the package, at "
                        + " <- ".join(f"{Path(f.filename).name}:{f.lineno}"
                                      for f in reversed(stack[-4:])))

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return seen


def check_kernel_a_unit(dev, table, pyr, gen):
    """Kernel A on a unit's flat scale-0 submanifold book (B * V rows):
    against gather_conv in f32 and bf16 (1e-4 / 1e-2 of the largest
    output), f32 bit equal to each building's own call on its own book
    and row order, bf16's difference to them reported; timed, with
    :func:`conv_bound`. Returns the bf16 line."""
    from detection_3d_tpu_torch.ops.sparse import neighbor_match_3x3x3
    from detection_3d_tpu_torch.ops.sparse_conv import (
        gather_conv, gather_conv_cuda, masks_row_order)
    nb, v = table.units, table.capacity
    idx, order = pyr["subm"][0].idx, pyr["subm"][0].order
    valid = table.row_valid.reshape(-1)
    singles = [neighbor_match_3x3x3(table.building(b)) for b in range(nb)]
    line = None
    for dtype in (torch.float32, torch.bfloat16):
        feats = (torch.randn((nb * v, 32), generator=gen, device=dev)
                 * valid[:, None]).to(dtype)
        w = (torch.randn((27, 32, 32), generator=gen, device=dev)
             * (2.0 / (27 * 32)) ** 0.5).to(dtype)
        got = gather_conv_cuda(feats, idx, w, valid, order)
        want = gather_conv(feats, idx, w, valid).float()
        scale = float(want.abs().max())
        tol = (1e-4 if dtype == torch.float32 else 1e-2) * max(scale, 1.0)
        err = float((got.float() - want).abs().max())
        check(err <= tol, f"kernel A unit {dtype}: max abs err {err} > {tol}")
        alone = 0.0
        for b, (bidx, masks) in enumerate(singles):
            rows = slice(b * v, (b + 1) * v)
            one = gather_conv_cuda(feats[rows], bidx, w, valid[rows],
                                   masks_row_order(masks))
            alone = max(alone, float((one.float() - got[rows].float())
                                     .abs().max()))
        if dtype == torch.float32:
            check(alone == 0.0, f"kernel A unit f32: differs from the "
                  f"buildings' own calls by {alone}")
        ms = time_ms(lambda: gather_conv_cuda(feats, idx, w, valid, order))
        plain = time_ms(lambda: gather_conv(feats, idx, w, valid), 3)
        b_ms, b_by, _ = conv_bound(feats, idx, w, valid)
        line = {"case": "unit s0 subm 32->32", "dtype": str(dtype)[6:],
                "B": nb, "K": 27, "V_in": nb * v, "V_out": nb * v,
                "max_abs_err": err, "tolerance": tol,
                "max_abs_diff_to_own_calls": alone, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None}
        print("kernel A unit shape", json.dumps(line))
    return line


def check_kernel_b_unit(table):
    """Kernel B over a unit's B stacked scale-0 tables in one launch: book
    and masks bit exact against the plain neighbor_match_columns and
    against each table's own launch (globalized); timed beside the plain
    version and ``torch.searchsorted`` over the (B, 27 V) queries
    (the lower bound only); the bound as :func:`subm_match_shapes`'s."""
    from detection_3d_tpu_torch.ops import sparse
    from detection_3d_tpu_torch.ops.coords import composite_key, pack_key
    nb, v = table.units, table.capacity
    got, masks = sparse.subm_match_cuda(table)
    want, want_m = sparse.neighbor_match_columns(table)
    check(torch.equal(got, want) and torch.equal(masks, want_m),
          "kernel B unit: book or masks differ from neighbor_match_columns")
    for b in range(nb):
        one, m = sparse.subm_match_cuda(table.building(b))
        glob = torch.where(one < v, one + b * v, nb * v)
        check(torch.equal(got[:, b * v:(b + 1) * v], glob)
              and torch.equal(masks[b * v:(b + 1) * v], m),
              f"kernel B unit: building {b} differs from its own launch")
    offs = sparse.submanifold_offsets((3, 3, 3))
    deltas = torch.tensor([[a, b, c, 0] for a, b, c in offs],
                          dtype=torch.int32, device=table.device)
    q = composite_key(*pack_key(
        table.coords[:, None] + deltas[None, :, None],
        table.spatial_size, table.row_valid[:, None, :])).reshape(nb, -1)
    searches = 0
    size = torch.tensor(table.spatial_size, device=table.device)
    for b in range(nb):
        c = table.coords[b, :int(table.num[b]), :3]
        searches += sum(int(((c + d[:3] >= 0) & (c + d[:3] < size))
                            .all(1).sum()) for d in deltas)
    probes = max(1, (v - 1).bit_length()) + 1
    nbytes = nb * (v * 8 + v * 16 + 4 + 27 * v * 4 + v * 8)
    b_ms, b_by = bound(nbytes, 4.0 * probes * searches, SCALAR_OPS)
    line = {"B": nb, "V": v, "num": [int(n) for n in table.num],
            "ms": time_ms(lambda: sparse.subm_match_cuda(table)),
            "device_ms": device_ms(lambda: sparse.subm_match_cuda(table),
                                   ("subm_match_",)),
            "plain_ms": time_ms(lambda: sparse.neighbor_match_columns(table),
                                2),
            "library_ms": time_ms(lambda: torch.searchsorted(table.keys, q)),
            "bound_ms": b_ms, "bound_by": b_by, "searches": searches,
            "max_abs_err": 0.0, "tolerance": "bit exact"}
    print("kernel B unit shape", json.dumps(line))
    return line


def check_kernel_c_unit(calls):
    """Kernel C at a unit's calls (its RPN NMS, G = B, and its ROI
    postprocess's, G = B * (classes - 1)), on the inputs the unit gave
    it: bit exact against rotated_iou_plain matrix by matrix; timed, the
    plain version matrix by matrix; the bound counts the pairs whose
    plain intersection is > 0 (the kernel culls the others)."""
    from detection_3d_tpu_torch.ops.rotated_iou import (
        rotated_iou_cuda, rotated_iou_plain)
    lines = []
    for boxes, query, crit, fix in calls:
        g, n, k = boxes.shape[0], boxes.shape[1], query.shape[1]
        full = rotated_iou_cuda(boxes, query, crit, fix)
        err, meeting = 0.0, 0
        for m in range(g):
            err = max(err, _hold_c(f"unit matrix {m} of {g}", full[m],
                                   rotated_iou_plain(boxes[m], query[m],
                                                     crit, fix)))
            meeting += int((rotated_iou_plain(boxes[m], query[m], 3) > 0)
                           .sum())
        nbytes = g * (5 * 4 * (n + k) + n * k * 4)
        b_ms, b_by = bound(nbytes, float(IOU_OPS_PER_PAIR) * meeting,
                           SCALAR_OPS)
        line = {"G": g, "N": n, "K": k, "criterion": crit,
                "ms": time_ms(lambda: rotated_iou_cuda(boxes, query, crit,
                                                       fix)),
                "plain_ms": time_ms(lambda: [
                    rotated_iou_plain(boxes[m], query[m], crit, fix)
                    for m in range(g)], 1),
                "pairs_meeting": meeting, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": None, "max_abs_err": err,
                "tolerance": "bit exact"}
        print("kernel C unit shape", json.dumps(line))
        lines.append(line)
    return lines


# an estimate, not a measurement, of the serial floor of kernel E's
# walk: every row of a matrix is taken to cost two dependent integer
# operations of ~4 cycles (the test of its bit, the predicated OR of its
# diagonal word) at the H100 SXM's 1.98 GHz boost clock; the G matrices
# walk at once. Printed on the "kernel E shape" lines only.
E_CYCLES_PER_ROW = 8
H100_CLOCK_HZ = 1.98e9


def _greedy_cases(dev):
    """(G, N, N) float32 IoU matrices with ties (equal rows, a block of
    overlaps in every row), entries at float32(t), beside it on both
    sides and NaN, and an all-invalid matrix, at N = 2000 and 1000, with
    their threshold t (0.7 and 0.1, neither exact in float32)."""
    out = []
    for n, g, t in ((2000, 2, 0.7), (1000, 5, 0.1)):
        rng = np.random.RandomState(n)
        t32 = np.float32(t)
        iou = (rng.rand(g, n, n) * t32).astype(np.float32)
        iou[rng.rand(g, n, n) > 0.97] = 0.9
        iou[:, :, :16] = 0.9
        edges = np.array([t32, np.nextafter(t32, np.float32(2)),
                          np.nextafter(t32, np.float32(-1)), np.nan],
                         np.float32)
        pick = rng.rand(g, n, n) < 0.02
        iou[pick] = edges[rng.randint(0, 4, int(pick.sum()))]
        iou[:, 7] = iou[:, 9]
        valid = rng.rand(g, n) > 0.1
        valid[-1] = False
        out.append((torch.from_numpy(iou).to(dev),
                    torch.from_numpy(valid).to(dev), t, n // 2))
    return out


def _greedy_large_case(dev, n=20000, t=0.5, seed=3):
    """One (1, N, N) float32 IoU matrix above N = 8192 (kernel E's walk
    with its mask in shared memory), drawn on the card: sparse overlaps
    (0.2 %), a block of overlaps in every row, entries at float32(t) and
    beside it, and 10 % invalid rows; its threshold and post = N / 4."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    t32 = float(np.float32(t))
    iou = torch.rand((1, n, n), generator=gen, device=dev) * t32
    iou[torch.rand((1, n, n), generator=gen, device=dev) > 0.998] = 0.9
    iou[:, :, :16] = 0.9
    edges = torch.tensor([t32, float(np.nextafter(np.float32(t), 2)),
                          float(np.nextafter(np.float32(t), -1))],
                         device=dev)
    pick = torch.rand((1, n, n), generator=gen, device=dev) < 0.002
    iou[pick] = edges[torch.randint(0, 3, (int(pick.sum()),), generator=gen,
                                    device=dev)]
    valid = torch.rand((1, n), generator=gen, device=dev) > 0.1
    return iou, valid, t, n // 4


def check_kernel_e(calls, dev):
    """Kernel E against the plain greedy pass (the compare in torch, the
    pass in numpy on the host): keep positions and counts identical at a
    unit's calls, at the cases of :func:`_greedy_cases` and at N = 20000
    (:func:`_greedy_large_case`, the walk above N = 8192); each call
    timed by CUDA events (``ms``: at these sizes the host's launches can
    set that pace) and its pack and walk launches by the profiler
    (``device_ms`` their sum), beside the torch compare ``iou > t`` E
    absorbs (``compare_ms``). The bound is the bytes: the entries right of
    the diagonal of the float32 matrices and the validity read once, the
    keep positions and counts written once. Each printed line also shows
    ``walk_floor_ms``, the estimate of the walk's serial floor (N rows,
    E_CYCLES_PER_ROW each), which the returned lines leave out."""
    from detection_3d_tpu_torch.ops.nms import greedy_cuda, greedy_plain
    lines = []
    cases = [(a, "unit") for a in calls] + [
        (a, "edges") for a in _greedy_cases(dev)] + [
        (_greedy_large_case(dev), "large")]
    for (iou, valid, t, post), what in cases:
        g, n = valid.shape
        k, c = greedy_cuda(iou, valid, t, post)
        pk, pc = greedy_plain(iou, valid, t, post)
        check(torch.equal(k, pk) and torch.equal(c, pc),
              f"kernel E ({what}, G={g}, N={n}): keep sets differ from "
              "the plain greedy pass")
        nbytes = (g * n * (n - 1) // 2 * 4 + g * n + g * post * 4
                  + g * 4)
        b_ms, b_by = bound(nbytes, float(g) * n * (n - 1) // 2, SCALAR_OPS)
        pack_ms, walk_ms = (device_ms(lambda: greedy_cuda(iou, valid, t, post),
                                      [sym])
                            for sym in ("greedy_nms_pack", "greedy_nms_walk"))
        line = {"case": what, "G": g, "N": n, "post": post,
                "threshold": t, "kept": [int(x) for x in c],
                "ms": time_ms(lambda: greedy_cuda(iou, valid, t, post)),
                "device_ms": (None if None in (pack_ms, walk_ms)
                              else pack_ms + walk_ms),
                "pack_device_ms": pack_ms,
                "walk_device_ms": walk_ms,
                "compare_ms": time_ms(lambda: iou > t),
                "plain_ms": time_ms(
                    lambda: greedy_plain(iou, valid, t, post), 2),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "max_abs_err": 0.0,
                "tolerance": "identical keep sets"}
        floor = n * E_CYCLES_PER_ROW / H100_CLOCK_HZ * 1e3
        print("kernel E shape", json.dumps({**line, "walk_floor_ms": floor}))
        lines.append(line)
    return lines


def batched_path(cfg, scenes, dev, gen):
    """Batched serving at full width: make_batch_predict_fn (table mode)
    over BATCH_BUILDINGS buildings at each of BATCH_SIZES, one forward a
    unit. Each unit within UNIT_SET_TOL (as sets) of the per-building
    predict on the card, and the graphed predict's unit (eager, the
    capture, then replays) bit equal to an eager twin's, whose wrapper
    launches are exactly UNIT_LAUNCHES (counts set to 0 before the unit
    and read after: a replay calls no wrapper); no host sync in a
    replayed unit (torch's sync debug mode), its busy ms and idle share
    (utils/profiling.device_activity) and the peak memory; the pipelined
    stream's s/building and buildings/s at each B
    (run_inference(pipelined=True)); kernels A, B, C and E held at the
    B = 4 unit's shapes. Returns ({path: launches}, {kernel: report});
    ``batched_unit_B<B>`` holds one eager unit's launches,
    ``batched_B<B>`` the stream's wrapper calls (its eager and capturing
    units only)."""
    from detection_3d_tpu_torch.data.native_packer import pack_table_native
    from detection_3d_tpu_torch.data.packing import to_device, unpack_table
    from detection_3d_tpu_torch.engine.inference import (
        make_batch_predict_fn, make_predict_fn, run_inference)
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from detection_3d_tpu_torch.ops import cuda_lib, nms
    from detection_3d_tpu_torch.utils.profiling import device_activity
    scenes = scenes[:BATCH_BUILDINGS]
    check(len(scenes) == BATCH_BUILDINGS, "batched phase: too few buildings")
    model = SparseRCNN(cfg, seed=0).to(dev).eval()
    packs = [pack_table_native(cfg, s) for s in scenes]
    one = make_predict_fn(cfg, model, dev, packed="table")
    with torch.inference_mode():
        singles = [tuple(t.cpu().numpy() for t in one(p)) for p in packs]
    launches, lines = {}, []
    for bs in BATCH_SIZES:
        predict = make_batch_predict_fn(cfg, model, dev, packed="table")
        eager = make_batch_predict_fn(cfg, model, dev, packed="table",
                                      graph=False)
        units = [list(range(i, i + bs)) for i in range(0, len(packs), bs)]
        torch.cuda.reset_peak_memory_stats()
        err = 0.0
        for ui, unit in enumerate(units):
            batch = to_device({k: np.stack([packs[i][k] for i in unit])
                               for k in packs[0]}, dev)
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            want = eager(batch)
            ln = dict(cuda_lib.launches)
            for name, n in UNIT_LAUNCHES.items():
                check(ln[name] == n, f"batched B={bs} unit {ui}: kernel "
                      f"{name} launched {ln[name]} times, not {n}")
            out, true_num = predict(batch)
            check(torch.equal(out, want[0]) and torch.equal(true_num,
                                                            want[1]),
                  f"batched B={bs} unit {ui}: the graphed predict differs "
                  "from the eager one")
            out, true_num = out.cpu().numpy(), true_num.cpu().numpy()
            for b, i in enumerate(unit):
                check(int(true_num[b]) == int(singles[i][1]),
                      f"batched B={bs}: building {i} true_num differs")
                e = _set_err(out[b], singles[i][0])
                check(e <= UNIT_SET_TOL, f"batched B={bs}: building {i} "
                      f"differs from its own predict by {e}")
                err = max(err, e)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        launches[f"batched_unit_B{bs}"] = ln
        syncs = _unit_syncs(lambda: predict(batch))
        check(not syncs, f"batched B={bs}: a unit waits for the card at "
              f"{syncs}")
        act = device_activity(lambda: predict(batch)[0].cpu(), dev)
        replays = predict.graphed.replays if predict.graphed else None
        check(replays in (None, len(units) + 1),      # None on the CPU
              f"batched B={bs}: {replays} replays")
        cuda_lib.reset_launches()
        preds, _, sec = run_inference(
            cfg, model, scenes, device=dev, pipelined=True, pack_workers=2,
            pack_mode="table", batch_size=bs)
        launches[f"batched_B{bs}"] = dict(cuda_lib.launches)
        for i, p in enumerate(preds):
            e = _set_err(np.c_[p["boxes"], p["scores"], p["labels"],
                               np.ones(len(p["scores"]))],
                         singles[i][0])
            check(e <= UNIT_SET_TOL, f"batched stream B={bs}: building {i} "
                  f"differs from its own predict by {e}")
        line = {"B": bs, "units": len(units), "s_per_building": sec,
                "buildings_per_s": 1.0 / sec, "unit_busy_ms": act["busy_ms"],
                "unit_span_ms": act["span_ms"],
                "unit_idle_share": act["idle_share"],
                "launches_per_unit": {k: ln[k] for k in UNIT_LAUNCHES},
                "replays": replays,
                "syncs_per_unit": len(syncs), "syncs": sorted(set(syncs)),
                "peak_gib": peak, "max_abs_err_vs_own_predict": err,
                "tolerance": UNIT_SET_TOL}
        print("batched serving:", json.dumps(line))
        lines.append(line)
    base = lines[0]["buildings_per_s"]
    print("batched serving summary: " + json.dumps(
        {f"B{ln['B']}": {"buildings_per_s": ln["buildings_per_s"],
                         "vs_B1": ln["buildings_per_s"] / base}
         for ln in lines}))
    # the kernels at the B = 4 unit's shapes
    bs = BATCH_SIZES[-1]
    batch = to_device({k: np.stack([packs[i][k] for i in range(bs)])
                       for k in packs[0]}, dev)
    # eager: the wrappers' recorded inputs must be this call's own
    predict = make_batch_predict_fn(cfg, model, dev, packed="table",
                                    graph=False)
    reports = {}
    with torch.inference_mode():
        iou_calls = capture_iou_calls(lambda: predict(batch))
        greedy_calls = _capture(nms, "greedy_cuda", lambda: predict(batch))
        table = unpack_table(cfg, batch)
        pyr = build_pyramid(table, cfg)
        reports["gather_conv"] = check_kernel_a_unit(dev, table, pyr, gen)
        reports["subm_match"] = check_kernel_b_unit(table)
        reports["rotated_iou"] = check_kernel_c_unit(iou_calls)
        reports["greedy_nms"] = check_kernel_e(greedy_calls, dev)
        del pyr, table
    check(len(iou_calls) == 2 and len(greedy_calls) == 2,
          f"batched B={bs}: {len(iou_calls)} C and {len(greedy_calls)} E "
          "calls in a unit")
    del model
    torch.cuda.empty_cache()
    return launches, reports, lines


SEG_ROOM_POINTS = 500_000   # one dense 8 m room: the seg_train shape


def minkunet_path(dev, seed=7):
    """MinkUNet34C at its published widths on one dense room (one 8 m room
    of 500k points, about 413k level-0 voxels), the segmentation cell's
    shape. On the room's level-0 table: kernel B's 5x5x5 form
    (subm_match_cuda at radius 2) bit equal to the plain column twin and
    to itself on a second call, one launch each; kernel A over the stem's
    125-offset book (two-word row masks, the ``_w2`` entries) against the
    plain A, 3 -> 32 in f32 and bf16; dW over the stem's entries-only
    book (weights_book) against the plain dW. A tolerance holds only if
    it is below what the plain A gives over the first 64 offsets alone.
    Then a Trainer of the model takes a warm-up step and one more with
    the launch counts set to 0 just before it: B 6 (five 3^3 books and
    the 5^3 one), A 55 (the stem, 4 stride-2 convs, 4 transposes, 46
    3^3 convs), dFeats 54 (none for the stem), dW 55. Returns (the
    step's launches, the kernel lines)."""
    import tempfile
    from detection_3d_tpu_torch.config.defaults import CapacityConfig
    from detection_3d_tpu_torch.data.synthetic import synthetic_multiroom
    from detection_3d_tpu_torch.engine.trainer import Trainer, pad_scene
    from detection_3d_tpu_torch.models.minkunet import (
        MinkUNet34C, MinkUNetConfig)
    from detection_3d_tpu_torch.ops import cuda_lib, sparse
    from detection_3d_tpu_torch.ops.sparse_conv import (
        gather_conv, gather_conv_cuda, gather_conv_dw, gather_conv_dw_cuda,
        masks_row_order, weights_book)
    cfg = MinkUNetConfig(caps=CapacityConfig(
        max_points=SEG_ROOM_POINTS,
        voxel_caps=(524288, 524288, 524288, 262144, 65536),
        max_gt=512)).validate()
    scene = synthetic_multiroom(seed=seed, num_points=SEG_ROOM_POINTS,
                                rooms_xy=(1, 1), room=8.0, voxel_scale=50,
                                classes=cfg.classes)
    # a label a height band of 0.5 m: the points of a voxel share one
    scene["point_labels"] = (scene["points"][:, 2] // 25).astype(
        np.int32) % cfg.out_channels
    model = MinkUNet34C.from_config(cfg, seed=0).to(dev)
    padded = pad_scene(cfg, scene)
    b = {k: torch.as_tensor(v).to(dev) for k, v in padded.items()}
    table, labels = model.voxelize(cfg, b["points"], b["feats"],
                                   b["points_valid"], b["point_labels"])
    v, num = table.rows, int(table.num)
    lines = {"voxels": num, "labelled": int((labels >= 0).sum())}

    before = cuda_lib.launches["subm_match"]
    idx, masks = sparse.subm_match_cuda(table, radius=2)
    again, masks_again = sparse.subm_match_cuda(table, radius=2)
    check(cuda_lib.launches["subm_match"] == before + 2,
          "MinkUNet: B's 5x5x5 form is not one launch a call")
    want, want_m = sparse.neighbor_match_columns(table, radius=2)
    check(idx.shape == (125, v) and masks.shape == (v, 2)
          and torch.equal(idx, want) and torch.equal(masks, want_m)
          and torch.equal(idx, again) and torch.equal(masks, masks_again),
          "MinkUNet: B's 5x5x5 book or masks differ from the column twin")
    pairs = int((idx < v).sum())
    lines["B5"] = {"V": v, "pairs": pairs, "pairs_per_voxel": pairs / num,
                   "ms": time_ms(lambda: sparse.subm_match_cuda(
                       table, radius=2)),
                   "device_ms": device_ms(lambda: sparse.subm_match_cuda(
                       table, radius=2), ("subm_match_",)),
                   "plain_ms": time_ms(lambda: sparse.neighbor_match_columns(
                       table, radius=2), 2),
                   "tolerance": "bit exact"}

    order = masks_row_order(masks)
    valid = table.row_valid.reshape(-1)
    gen = torch.Generator(device=dev).manual_seed(seed)
    x32 = table.feats.to(torch.float32)
    w32 = torch.randn((125, x32.shape[1], 32), generator=gen, device=dev)
    g32 = torch.randn((v, 32), generator=gen, device=dev)
    book = weights_book(idx, v, valid)
    check(book.t_idx is None and book.t_order is None
          and int(book.starts[-1]) == pairs,
          "MinkUNet: the stem's weights book is not entries alone")
    plain = gather_conv(x32, idx, w32, valid)
    scale = float(plain.abs().max())
    first_word = float((gather_conv(x32, idx[:64], w32[:64], valid) - plain)
                       .abs().max()) / scale
    for dtype, tol_a, tol_dw in ((torch.float32, 1e-5, 1e-4),
                                 (torch.bfloat16, 1e-2, 1e-2)):
        check(tol_a < first_word,
              f"MinkUNet: A's {dtype} tolerance {tol_a} would pass the "
              f"first 64 offsets alone ({first_word:.3g})")
        x, w, g = x32.to(dtype), w32.to(dtype), g32.to(dtype)
        got = gather_conv_cuda(x, idx, w, valid, order)
        ref = gather_conv(x, idx, w, valid)
        err_a = float((got.float() - ref.float()).abs().max()) / max(
            float(ref.float().abs().max()), 1e-30)
        check(err_a <= tol_a, f"MinkUNet: A at 125 offsets, {dtype}: "
              f"{err_a:.3g} of the largest > {tol_a}")
        dw = gather_conv_dw_cuda(x, g, book)
        dw_ref = gather_conv_dw(x, g, book)
        err_dw = float((dw.float() - dw_ref.float()).abs().max()) / max(
            float(dw_ref.float().abs().max()), 1e-30)
        check(err_dw <= tol_dw, f"MinkUNet: the stem's dW, {dtype}: "
              f"{err_dw:.3g} of the largest > {tol_dw}")
        lines[f"A125_{str(dtype)[6:]}"] = {
            "rel_err": err_a, "tolerance": tol_a,
            "first_64_offsets_alone": first_word,
            "ms": time_ms(lambda: gather_conv_cuda(x, idx, w, valid, order)),
            "plain_ms": time_ms(lambda: gather_conv(x, idx, w, valid), 2)}
        lines[f"dW125_{str(dtype)[6:]}"] = {
            "rel_err": err_dw, "tolerance": tol_dw,
            "ms": time_ms(lambda: gather_conv_dw_cuda(x, g, book)),
            "plain_ms": time_ms(lambda: gather_conv_dw(x, g, book), 2)}
    del plain, got, ref, dw, dw_ref, book, idx, masks, again, want
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as out:
        trainer = Trainer(cfg, output_dir=out, device=dev)
        state = trainer.init_state(model=model)
        total, _, ok, _ = trainer.step(state, padded, priorities={})
        check(ok and np.isfinite(total), "MinkUNet: the warm-up step failed")
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        total, _, ok, _ = trainer.step(state, padded, priorities={})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(cuda_lib.launches)
    want_l = {"subm_match": 6, "gather_conv": 55, "gather_conv_dfeats": 54,
              "gather_conv_dw": 55}
    check(ok and np.isfinite(total)
          and all(launches[k] == n for k, n in want_l.items()),
          f"MinkUNet: a step's launches {launches}, expected {want_l}")
    lines["step"] = {"loss": total, "s": seconds, "launches": launches,
                     "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    print("MinkUNet34C seg_train shape", json.dumps(lines))
    return launches, lines


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor
    from detection_3d_tpu_torch.config.defaults import full_scale_config
    from detection_3d_tpu_torch.data import native_loader, native_packer
    from detection_3d_tpu_torch.data.synthetic import synthetic_multiroom
    from detection_3d_tpu_torch.engine.inference import (
        make_predict_fn, pad_scene, run_inference)
    from detection_3d_tpu_torch.models.detector import (
        SparseRCNN, voxelize_points)
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.tools.overfit_check import GROUPS_3G6C

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:   # g++ beside the nvccs
        host_libs = [pool.submit(native_packer.library),
                     pool.submit(native_loader.library)]
        per_src = cuda_lib.build()
        for lib in host_libs:
            lib.result()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(per_src)} sources in parallel "
          + json.dumps({k: round(v, 1) for k, v in per_src.items()})
          + " and the C++ pyramid packer and scene loader (g++)")
    for name in cuda_lib.KERNELS:
        log = cuda_lib.lib_path(name).with_suffix(".log")
        if log.exists():
            for ln in log.read_text().splitlines():
                if "registers" in ln or "spill" in ln:
                    print(f"  ptxas {name}: {ln.strip()}")

    cfg = full_scale_config()
    t0 = time.perf_counter()
    scenes = [synthetic_multiroom(seed=100 + i, num_points=POINTS,
                                  rooms_xy=(5, 5), room=8.0,
                                  voxel_scale=cfg.sparse3d.voxel_scale)
              for i in range(max(BUILDINGS, TRAIN_STEPS + 1,
                                 BATCH_BUILDINGS))]
    print(f"generated {len(scenes)} buildings in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- kernels against their plain versions, main-path shapes --------
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        batch = pad_scene(cfg, scenes[0])
        table0 = voxelize_points(cfg, *(torch.as_tensor(batch[k]).to(dev)
                                        for k in ("points", "feats",
                                                  "points_valid")))
        pyr = build_pyramid_checked(cfg, table0)
        tables = pyr["tables"]
        table1, crb, drb = tables[1], pyr["down"][0].idx, pyr["up"][0].idx
        idx0, idx1 = (b.idx for b in pyr["subm"][:2])
        print(f"scale-0 table: {int(table0.num)} of {table0.capacity} rows "
              f"(true_num {int(table0.true_num)}); scale 1: "
              f"{int(table1.num)} of {table1.capacity}")
        rep_b, rep_b_sum = subm_match_shapes(tables)
        rep_a = check_gather_conv(dev, table0, table1, crb, idx0, idx1, gen)
        rep_ab = check_gather_conv_bwd(dev, table0, table1, crb, idx0, idx1,
                                       gen)
        rep_d, rep_d_sum = check_multi_match(tables, cfg, crb, drb)
        rep_c = check_rotated_iou(dev)
        del pyr, tables, table0, table1, crb, drb, idx0, idx1
    torch.cuda.empty_cache()

    # ---- the serving path at full width ---------------------------------
    model = SparseRCNN(cfg, seed=0)
    # eager: the stage spans, the device profile and kernel A's recorded
    # shapes read the forward's own calls
    predict = make_predict_fn(cfg, model, device="cuda", graph=False)
    main_scenes = scenes[:BUILDINGS]
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    preds, _, sec = run_inference(cfg, model, main_scenes, predict_fn=predict)
    wall = time.perf_counter() - t0
    serve = dict(cuda_lib.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("gather_conv", "subm_match", "rotated_iou"):
        check(serve[name] > 0, f"kernel {name} was not launched on the "
              "serving path")
    for i, p in enumerate(preds):
        check(p["true_num"] > 0, f"building {i}: true_num == 0")
        check(p["boxes"].shape[0] > 0, f"building {i}: no detections")
        check(bool(np.isfinite(p["boxes"]).all()
                   and np.isfinite(p["scores"]).all()),
              f"building {i}: non-finite detections")
    print(f"serving path: {len(preds)} buildings in {wall:.2f} s, "
          f"{sec:.4f} s/building over buildings 2..{len(preds)} "
          f"(host clock, padded arrays in -> detections on host), peak "
          f"device memory {peak_gb:.2f} GiB, launches {json.dumps(serve)}")
    print("detections per building: "
          + json.dumps([int(p["boxes"].shape[0]) for p in preds])
          + ", true_num: " + json.dumps([p["true_num"] for p in preds]))

    t0 = time.perf_counter()
    stages = stage_spans(predict, pad_scene(cfg, scenes[-1]))
    print(f"stages of one more building (span log: host seconds, own "
          f"host syncs; {time.perf_counter() - t0:.3f} s total): "
          + json.dumps({k: [round(v[0], 4), v[1]]
                        for k, v in stages.items()}))
    prof = device_profile(predict, pad_scene(cfg, scenes[-1]))
    print("device profile of one more building: " + json.dumps(_brief(prof)))
    gather_conv_serving_shapes(predict, pad_scene(cfg, scenes[-1]))
    del model, predict
    torch.cuda.empty_cache()

    # ---- the packed forms and pipelined serving at full width -----------
    t0 = time.perf_counter()
    packed_launches, _ = packed_serving_path(cfg, scenes, dev)
    torch.cuda.empty_cache()
    print(f"packed serving phase: {time.perf_counter() - t0:.1f} s")

    # ---- one forward over a unit of B buildings (this slice's path) -----
    t0 = time.perf_counter()
    batched, rep_unit, _ = batched_path(cfg, scenes, dev, gen)
    print(f"batched serving phase: {time.perf_counter() - t0:.1f} s")

    # ---- MinkUNet34C's kernels and one training step, one dense room ----
    t0 = time.perf_counter()
    seg_train, _ = minkunet_path(dev)
    torch.cuda.empty_cache()
    print(f"MinkUNet34C phase: {time.perf_counter() - t0:.1f} s")

    # ---- the training path at full width --------------------------------
    train, rep_train, rep_bwd, iou_calls = train_path(cfg, scenes, dev)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        rep_c["training_shapes"] = check_rotated_iou_training(iou_calls)
    del iou_calls

    pyramid_seconds(cfg, scenes[0], dev)

    # ---- the training input path at full width --------------------------
    t0 = time.perf_counter()
    input_launches = train_input_path(cfg, scenes, dev)
    torch.cuda.empty_cache()
    print(f"training input phase: {time.perf_counter() - t0:.1f} s")

    # ---- the train-and-evaluate entry point at full width ---------------
    t0 = time.perf_counter()
    evaluate, rep_c["evaluator_shapes"] = train_eval_path(
        cfg, scenes[:2 * HOUSES], dev, rep_train["s_per_step"])
    torch.cuda.empty_cache()
    print(f"train-and-evaluate phase: {time.perf_counter() - t0:.1f} s")

    # ---- the separate-classifier (3G6c) configuration ------------------
    t0 = time.perf_counter()
    g3 = groups_3g6c_path(cfg.replace(separate_classes=GROUPS_3G6C), scenes,
                          dev, tiny_3g6c_config(),
                          tiny_config().replace(rpn_only=True))
    torch.cuda.empty_cache()
    print(f"3g6c phase: {time.perf_counter() - t0:.1f} s")

    # ---- the generic sparse networks (UNet, VGG, FCN) at full width -----
    t0 = time.perf_counter()
    zoo, zoo_lines = zoo_path(cfg, scenes[0], dev, gen)
    torch.cuda.empty_cache()
    print(f"zoo phase: {time.perf_counter() - t0:.1f} s")

    # ---- dataset preparation from a SUNCG house to a training step ------
    t0 = time.perf_counter()
    dataprep = dataprep_path(cfg, dev)
    torch.cuda.empty_cache()
    print(f"dataprep phase: {time.perf_counter() - t0:.1f} s")

    # ---- rotate_nms_3d (C), conv_rulebook / deconv_rulebook (D) ---------
    t0 = time.perf_counter()
    api = api_path(cfg, scenes[0], dev)
    print(f"api phase: {time.perf_counter() - t0:.1f} s")

    # ---- the repo-level tools' twins ------------------------------------
    t0 = time.perf_counter()
    tools = tools_path(cfg, scenes, dev)
    torch.cuda.empty_cache()
    print(f"tools phase: {time.perf_counter() - t0:.1f} s")

    # ---- kernel D's own entry points ------------------------------------
    match = match_path(cfg, scenes[0], dev)

    # ---- multi-device: data parallelism, spatial sharding, dp x sp ------
    t0 = time.perf_counter()
    par_launches, rep_d["sp_shard_books"] = parallel_path(cfg, scenes, dev)
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s")

    # ---- small-input reference: kernels on the card vs plain on the CPU -
    tcfg = tiny_config()
    scene = tiny_scene(tcfg)
    tiny_predict_card_vs_cpu(tcfg, scene)
    tiny_train_card_vs_cpu(tcfg, scene)

    # ---- the masked BN: its sites, and its launches on every path ------
    t0 = time.perf_counter()
    rep_bn = bn_report([bn_site(*site, dev) for site in BN_SITES])
    torch.cuda.empty_cache()
    print(f"masked BN phase: {time.perf_counter() - t0:.1f} s")
    # every path that runs a model (eval counts the evaluator's calls
    # alone); a path that trains launches the backward's two as well
    bn_paths = {"serve": serve, "train": train, "seg_train": seg_train,
                "dataprep": dataprep,
                **{path: g3[path] for path in ("serve_3g6c", "train_3g6c",
                                               "rpn_only")},
                **packed_launches, **input_launches, **batched,
                **par_launches}
    print("masked BN launches by path: " + json.dumps(
        {path: [counts[k] for k in BN_KERNELS]
         for path, counts in bn_paths.items()}))
    missing = [f"{k} on {path}" for path, counts in bn_paths.items()
               for k in (BN_KERNELS if "train" in path or path == "dataprep"
                         else BN_KERNELS[:2]) if counts[k] == 0]
    check(not missing, "masked BN: not launched: " + ", ".join(missing))

    # ---- the ROI pooler: its shapes, and its launches on every path ----
    t0 = time.perf_counter()
    rep_roi = roi_path(cfg, scenes, dev)
    torch.cuda.empty_cache()
    print(f"ROI phase: {time.perf_counter() - t0:.1f} s")
    # every path through the detector's ROI head launches the forward, a
    # path that trains the backward too; MinkUNet34C and the rpn_only
    # model have no ROI head
    print("ROI launches by path: " + json.dumps(
        {path: [counts[k] for k in ROI_KERNELS]
         for path, counts in bn_paths.items()}))
    missing = [f"{k} on {path}" for path, counts in bn_paths.items()
               if path not in ROI_BYPASS
               for k in (ROI_KERNELS if "train" in path or path == "dataprep"
                         else ROI_KERNELS[:1]) if counts[k] == 0]
    missing += [f"none on {path}" for path in ROI_BYPASS
                if any(bn_paths[path][k] for k in ROI_KERNELS)]
    check(not missing, "ROI: launches wrong: " + ", ".join(missing))

    # launches: each kernel's count on the path it serves (training for
    # A, A', B, C; a spatial shard's serving, rank 0's, for D); every
    # path's count beside
    pg = "detection_3d_tpu/ops/pallas/"
    spec = [("gather_conv", "gather_conv.cu",
             pg + "gather_conv_kernel.py:245", rep_a, train),
            ("gather_conv_dfeats", "gather_conv.cu",
             pg + "gather_conv_kernel.py:308", rep_ab["dfeats"], train),
            ("gather_conv_dw", "gather_conv_bwd.cu",
             pg + "gather_conv_kernel.py:308", rep_ab["dw"], train),
            ("subm_match", "subm_match.cu", pg + "match_kernel.py:193",
             rep_b, train),
            ("rotated_iou", "rotated_iou.cu",
             pg + "rotated_iou_kernel.py:196", rep_c, train),
            ("multi_match", "multi_match.cu", pg + "match_kernel.py:399",
             rep_d, par_launches["sp_serve_rank0"]),
            ("greedy_nms", "greedy_nms.cu", "detection_3d_tpu/ops/nms.py:39",
             rep_unit["greedy_nms"][0],
             batched[f"batched_unit_B{BATCH_SIZES[-1]}"])]
    spec += [(name, "masked_bn.cu",
              "detection_3d_tpu/ops/norm.py (XLA's fusion)", rep_bn, train)
             for name in BN_KERNELS]
    rep_roi_bwd = {"max_abs_err": rep_roi["max_abs_err"],
                   "ms": rep_roi["bwd"]["bwd_ms"],
                   "device_ms": rep_roi["bwd"]["bwd_device_ms"],
                   "kernels_device_ms": rep_roi["bwd"][
                       "bwd_kernels_device_ms"],
                   "plain_ms": rep_roi["bwd"]["plain_bwd_ms"],
                   "bound_ms": rep_roi["bwd"]["bwd_bound_ms"],
                   "bound_by": "bytes: the gradient read, the rows' "
                               "gradient written", "library_ms": None}
    spec += [(name, "roi_align.cu",
              "detection_3d_tpu/ops/roi_align.py (XLA's fusion)", rep, train)
             for name, rep in zip(ROI_KERNELS, (rep_roi, rep_roi_bwd))]
    kernels = []
    for name, src, replaces, rep, path in spec:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "detection_3d_tpu_torch/csrc/" + src,
            "replaces": replaces, "launches": path[name],
            "launches_by_path": {"serve": serve[name], "train": train[name],
                                 "match": match[name],
                                 "eval": evaluate[name],
                                 **{path: counts[name] for path, counts
                                    in packed_launches.items()},
                                 **{path: counts[name] for path, counts
                                    in input_launches.items()},
                                 **{path: g3[path][name] for path in
                                    ("serve_3g6c", "train_3g6c",
                                     "rpn_only")},
                                 **{path: counts[name] for path, counts
                                    in par_launches.items()},
                                 **{path: counts[name] for path, counts
                                    in zoo.items()},
                                 "dataprep": dataprep[name],
                                 **{path: counts[name] for path, counts
                                    in api.items()},
                                 **{path: counts[name] for path, counts
                                    in tools.items()},
                                 **{path: counts[name] for path, counts
                                    in batched.items()},
                                 "seg_train": seg_train[name]},
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"],
            "library_ms": rep.get("library_ms")})
        if "bound_all_pairs_ms" in rep:
            kernels[-1]["bound_all_pairs_ms"] = rep["bound_all_pairs_ms"]
        for key in ("device_ms", "compare_ms",   # E
                    "kernels_device_ms"):          # ROI'
            if key in rep:
                kernels[-1][key] = rep[key]
        if rep.get("library_ms") is not None:
            kernels[-1]["library_computes"] = rep.get(
                "library_computes", "torch.searchsorted over the same "
                "composite queries: the lower bound only")
        if name == BN_KERNELS[0]:  # every site, once
            kernels[-1]["sites"] = rep_bn["sites"]
        if name == ROI_KERNELS[0]:  # every shape, once
            kernels[-1]["shapes"] = rep_roi["shapes"]
        if name == "subm_match":   # the sums over the 9 tables of a building
            kernels[-1].update(rep_b_sum)
        if name in rep_unit:       # at the shapes of a unit of buildings
            kernels[-1]["unit_shapes"] = rep_unit[name]
        if name == "multi_match":  # the sums over the 16 books of a pyramid
            kernels[-1].update(rep_d_sum)
            # and over the 16 books of a spatial shard's pyramid (rank 0)
            kernels[-1]["sp_shard_books"] = rep_d["sp_shard_books"]
        zoo_part = {"gather_conv": "A", "gather_conv_dfeats": "dfeats",
                    "gather_conv_dw": "dw"}.get(name)
        if zoo_part:   # the UNet's level-0 and deepest shapes
            kernels[-1]["zoo_shapes"] = [ln for ln in zoo_lines
                                         if ln["part"] == zoo_part]
        part = {"gather_conv_dfeats": "dfeats", "gather_conv_dw": "dw"}.get(
            name)
        if part:     # the sums over every shape of one training step
            for key in ("sum_ms", "sum_device_ms", "sum_bound_ms"):
                kernels[-1][f"{key}_per_step"] = \
                    rep_bwd[f"{part}_{key}_per_step"]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels, "launches_count": (
        "wrapper calls (ops/cuda_lib.launches); a replayed CUDA graph calls "
        "no wrapper, so a graphed serving path (serve_points, serve_table, "
        "serve_pyramid, pipelined_*, serve_3g6c, rpn_only, bench_*, "
        "batched_B*) counts its eager and capturing forwards only; "
        "batched_unit_B* is one eager unit's")}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def bwd_shapes_main():
    """``--bwd-shapes``: only :func:`gather_conv_bwd_training_shapes` at
    full width (a Trainer on the card takes a warm-up step, then the
    captured one); to time another tree of the package in the same call,
    copy this script into it."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import shutil
    from detection_3d_tpu_torch.config.defaults import full_scale_config
    from detection_3d_tpu_torch.data.synthetic import synthetic_multiroom
    from detection_3d_tpu_torch.engine.trainer import Trainer, pad_scene
    from detection_3d_tpu_torch.ops import cuda_lib
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    t0 = time.perf_counter()
    cuda_lib.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    cfg = full_scale_config()
    scenes = [synthetic_multiroom(seed=100 + i, num_points=POINTS,
                                  rooms_xy=(5, 5), room=8.0,
                                  voxel_scale=cfg.sparse3d.voxel_scale)
              for i in range(2)]
    out_dir = cuda_lib.BUILD_DIR / "train_smoke"    # gitignored, removed
    trainer = Trainer(cfg, output_dir=str(out_dir), device=dev)
    state = trainer.init_state(seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    trainer.step(state, pad_scene(cfg, scenes[0]), gen)
    batch = pad_scene(cfg, scenes[1])
    gather_conv_bwd_training_shapes(lambda: trainer.step(state, batch, gen))
    shutil.rmtree(out_dir, ignore_errors=True)
    print(card_line())
    return 0


def compare_main():
    """``--compare``: only the phases that use nothing but the package's
    public forms, so that they run the same in another tree of it: kernel
    D on every book of one full-size building (:func:`check_multi_match`)
    and the host clock of its pyramid (:func:`pyramid_seconds`). To
    compare two trees in one call, copy this script into the other and
    run the two in turn."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from detection_3d_tpu_torch.config.defaults import full_scale_config
    from detection_3d_tpu_torch.data.synthetic import synthetic_multiroom
    from detection_3d_tpu_torch.engine.inference import pad_scene
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.models.detector import voxelize_points
    from detection_3d_tpu_torch.ops import cuda_lib
    dev = torch.device("cuda")
    print(f"card: {card_line()}")
    t0 = time.perf_counter()
    cuda_lib.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    cfg = full_scale_config()
    scene = synthetic_multiroom(seed=100, num_points=POINTS, rooms_xy=(5, 5),
                                room=8.0, voxel_scale=cfg.sparse3d.voxel_scale)
    with torch.inference_mode():
        batch = pad_scene(cfg, scene)
        table0 = voxelize_points(cfg, *(torch.as_tensor(batch[k]).to(dev)
                                        for k in ("points", "feats",
                                                  "points_valid")))
        pyr = build_pyramid(table0, cfg)
        check_multi_match(pyr["tables"], cfg, pyr["down"][0].idx,
                          pyr["up"][0].idx)
        del pyr, table0
    pyramid_seconds(cfg, scene, dev)
    print(card_line())
    return 0


def d_forms_main():
    """``--d-forms``: kernel D's three forms (binary, quad, compact) on
    the 17 query sets of one full-size building
    (:func:`multi_match_sets`), each bit exact against multi_match_plain,
    with its profiler device ms and the form the wrapper chooses; the
    sums over a pyramid's 16 books."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from detection_3d_tpu_torch.config.defaults import full_scale_config
    from detection_3d_tpu_torch.data.synthetic import synthetic_multiroom
    from detection_3d_tpu_torch.engine.inference import pad_scene
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.models.detector import voxelize_points
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.ops.multi_match import (
        FORMS, multi_match_cuda, multi_match_form, multi_match_plain)
    dev = torch.device("cuda")
    print(f"card: {card_line()}")
    cuda_lib.build()
    cfg = full_scale_config()
    scene = synthetic_multiroom(seed=100, num_points=POINTS, rooms_xy=(5, 5),
                                room=8.0, voxel_scale=cfg.sparse3d.voxel_scale)
    with torch.inference_mode():
        batch = pad_scene(cfg, scene)
        table0 = voxelize_points(cfg, *(torch.as_tensor(batch[k]).to(dev)
                                        for k in ("points", "feats",
                                                  "points_valid")))
        sets = multi_match_sets(build_pyramid(table0, cfg)["tables"], cfg)
        sums = dict.fromkeys(FORMS, 0.0)
        for name, keys, qs, _ in sets:
            want = multi_match_plain(keys, qs)
            line = {"book": name, "V": keys.numel(), "queries": qs.numel(),
                    "chosen": multi_match_form(keys.numel(), qs.numel())}
            for form in FORMS:
                check(torch.equal(multi_match_cuda(keys, qs, form=form),
                                  want),
                      f"kernel D form {form} differs ({name})")
                line[f"{form}_device_ms"] = device_ms(
                    lambda: multi_match_cuda(keys, qs, form=form),
                    ("multi_match",))
                if "shuffled" not in name:
                    sums[form] += line[f"{form}_device_ms"] or 0.0
            print("kernel D forms", json.dumps(line))
        print("kernel D forms per pyramid:", json.dumps(
            {f"{form}_device_ms": v for form, v in sums.items()}))
    print(card_line())
    return 0


def overfit_main():
    """``--overfit``: the overfit gate with the 3G6c groups on the card
    (tools/overfit_check.py ``--groups`` at its default 4000 steps): one
    building, trained device-resident, evaluated, gated on per-class AP.
    Prints the per-class AP, the mean AP and AIoU and the wall time
    beside the card's line; exits with the gate's code."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import shutil
    from detection_3d_tpu_torch.data import native_packer
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.tools import overfit_check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    t0 = time.perf_counter()
    cuda_lib.build()
    native_packer.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    out = cuda_lib.BUILD_DIR / "overfit_smoke"      # gitignored, removed
    t0 = time.perf_counter()
    code = overfit_check.main(["--groups", "--output-dir", str(out)])
    wall = time.perf_counter() - t0
    summary = json.loads((out / "summary.json").read_text())
    shutil.rmtree(out, ignore_errors=True)
    print("overfit gate (3G6c groups): " + json.dumps(
        {"exit_code": code, "wall_s": wall, **summary}))
    print(card_line())
    return code


def parallel_main():
    """``--parallel``: only the multi-device phase (:func:`parallel_path`)
    at full width, after building the kernels; prints the card line and
    the ok line as the whole run does."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from detection_3d_tpu_torch.config.defaults import full_scale_config
    from detection_3d_tpu_torch.data.synthetic import synthetic_multiroom
    from detection_3d_tpu_torch.ops import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {card_line()}")
    t0 = time.perf_counter()
    cuda_lib.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    cfg = full_scale_config()
    scenes = [synthetic_multiroom(seed=100 + i, num_points=POINTS,
                                  rooms_xy=(5, 5), room=8.0,
                                  voxel_scale=cfg.sparse3d.voxel_scale)
              for i in range(2 * PAR_DP_STEPS)]
    t0 = time.perf_counter()
    launches, books = parallel_path(cfg, scenes)
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"launches_by_path": launches,
                      "sp_shard_books": books}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def batched_main():
    """``--batched``: only the batched-serving phase (:func:`batched_path`)
    at full width, after building the kernels; prints the card line and
    the ok line as the whole run does."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from detection_3d_tpu_torch.config.defaults import full_scale_config
    from detection_3d_tpu_torch.data import native_packer
    from detection_3d_tpu_torch.data.synthetic import synthetic_multiroom
    from detection_3d_tpu_torch.ops import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    t0 = time.perf_counter()
    cuda_lib.build()
    native_packer.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    cfg = full_scale_config()
    dev = torch.device("cuda")
    scenes = [synthetic_multiroom(seed=100 + i, num_points=POINTS,
                                  rooms_xy=(5, 5), room=8.0,
                                  voxel_scale=cfg.sparse3d.voxel_scale)
              for i in range(BATCH_BUILDINGS)]
    t0 = time.perf_counter()
    launches, _, lines = batched_path(
        cfg, scenes, dev, torch.Generator(device=dev).manual_seed(0))
    print(f"batched serving phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"launches_by_path": launches, "batched": lines}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def minkunet_main():
    """``--minkunet``: only MinkUNet34C's phase (:func:`minkunet_path`)
    after building the kernels; prints the card line and the ok line as
    the whole run does."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from detection_3d_tpu_torch.ops import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    t0 = time.perf_counter()
    cuda_lib.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, _ = minkunet_path(torch.device("cuda"))
    print(f"MinkUNet34C phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"launches_by_path": {"seg_train": launches}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# masked BN sites that --bn times: (name, B, rows V, valid rows (a
# prefix, as a table's), C, eps, leakiness). MinkUNet34C's levels 0, 2
# and 4 at its caps and the dense one-room mix's voxels (~413k, 73k,
# 2k), the detector's level 0 (480,752 voxels of a 5 x 5-room building)
# alone and in a unit of 4, and the ROI head's 1000 rois x 6 x 8 rows.
BN_SITES = (
    ("seg_train level 0, 32", 1, 524288, 413000, 32, 1e-5, 0.0),
    ("seg_train level 0, 96, BN alone", 1, 524288, 413000, 96, 1e-5, 1.0),
    ("seg_train level 2, 128", 1, 524288, 73000, 128, 1e-5, 0.0),
    ("seg_train level 4, 256", 1, 65536, 2000, 256, 1e-5, 0.0),
    ("detector level 0, 32", 1, 524288, 480752, 32, 1e-4, 0.0),
    ("detector level 0, 32, unit of 4", 4, 524288, 480752, 32, 1e-4, 0.0),
    ("ROI head, 512", 1, 48000, 48000, 512, 1e-4, 0.0),
)
BN_SYMBOLS = ("masked_bn_stats_rows", "masked_bn_stats_fold",
              "masked_bn_normalise", "masked_bn_dsums_rows",
              "masked_bn_dsums_fold", "masked_bn_dx")


def _bn_err(got, want, parts=1):
    """The largest error of ``got`` in units of the largest |want|, each
    of ``parts`` equal slices of the last axis apart (a sums vector's
    count, sum x and sum x^2)."""
    got, want = got.double(), want.double()
    errs = []
    for g, w in zip(got.chunk(parts, -1), want.chunk(parts, -1)):
        errs.append(((g - w).abs().max() / w.abs().max().clamp(
            min=1e-30)).item())
    return max(errs)


def _bn_rel_l2(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm().clamp(min=1e-30)).item()


def bn_site(name, b, v, n_valid, c, eps, leak, dev):
    """One masked BN site in bf16, checked, then timed. The kernels' sums
    (statistics; the backward's sums and their total over B) within 1e-5
    of the plain twins' largest, each part apart, the row count exact;
    given the kernel's sums the output and dx bit equal to the twins'.
    The whole chain, batch_norm_leaky_relu under autograd (the
    Function, one launch of each kernel), gives the kernels' bits and
    the total as the scale's and bias's gradients; against the plain
    version under autograd, its output and dx within 1e-2 in relative
    L2 norm (each side takes its own sums, so a row whose y lies within
    a rounding of 0 may take the other slope: the largest error can be
    a whole element), the parameters' gradients within 1e-2 of the
    largest. Then the forward (statistics + normalise) and the backward
    (sums + dx) are timed by CUDA events and by the profiler, beside the
    plain version's forward and autograd backward and
    torch.nn.functional.batch_norm + relu over the valid rows alone
    (timed only, as a yardstick: the port never calls it). Every loop
    reruns one site's inputs, so the times are warm in L2 (50 MB) where
    the site's tensors fit. The bound counts the valid rows' bytes (x
    read and the output written forward; x and the gradient read and dx
    written backward), and beside it the padding rows' zeros written
    each way."""
    import torch.nn.functional as F
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.ops.norm import (
        batch_norm_leaky_relu, batch_norm_leaky_relu_plain,
        masked_grad_apply, masked_grad_apply_cuda, masked_grad_sums,
        masked_grad_sums_cuda, masked_sums, masked_sums_cuda,
        normalise_cuda, normalise_plain)
    gen = torch.Generator(device=dev).manual_seed(v + c)
    dt = torch.bfloat16
    x = (torch.randn((b, v, c), generator=gen, device=dev) * 2 + 1).to(dt)
    valid = torch.zeros((b, v), dtype=torch.bool, device=dev)
    valid[:, :n_valid] = True
    scale = torch.rand((c,), generator=gen, device=dev) + 0.5
    bias = torch.randn((c,), generator=gen, device=dev)
    dout = torch.randn((b, v, c), generator=gen, device=dev).to(dt)
    sums = masked_sums_cuda(x, valid)
    out = normalise_cuda(x, valid, sums, scale, bias, leak, eps)
    gsums, total = masked_grad_sums_cuda(x, dout, valid, sums, scale, bias,
                                         leak, eps)
    dx = masked_grad_apply_cuda(x, dout, valid, sums, gsums, scale, bias,
                                leak, eps)
    want_sums = masked_sums(x, valid)
    want_gsums = masked_grad_sums(x, dout, valid, sums, scale, bias, leak,
                                  eps)
    errs = {"sums": _bn_err(sums[:, 1:], want_sums[:, 1:], 2),
            "gsums": _bn_err(gsums, want_gsums, 2),
            "total": _bn_err(total, want_gsums.sum(0), 2)}
    check(torch.equal(sums[:, 0], want_sums[:, 0]),
          f"masked BN {name}: the row counts differ from the twin's")
    for k, e in errs.items():
        check(e <= 1e-5, f"masked BN {name}: {k} off the twin's by {e:.3g} "
              "of the largest")
    check(torch.equal(out, normalise_plain(x, valid, sums, scale, bias,
                                           leak, eps)),
          f"masked BN {name}: the output differs from its twin's")
    check(torch.equal(dx, masked_grad_apply(x, dout, valid, sums, gsums,
                                            scale, bias, leak, eps)),
          f"masked BN {name}: dx differs from its twin's")

    xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))
    before = dict(cuda_lib.launches)
    y = batch_norm_leaky_relu(xs, valid, ss, bs, leak, eps)
    chain = (y,) + torch.autograd.grad(y, (xs, ss, bs), dout)
    for k in BN_KERNELS:
        check(cuda_lib.launches[k] == before[k] + 1,
              f"masked BN {name}: the chain launched {k} "
              f"{cuda_lib.launches[k] - before[k]} times")
    check(all(torch.equal(g, w) for g, w in zip(
        chain, (out, dx, total[c:], total[:c]))),
          f"masked BN {name}: the chain differs from its kernels")
    xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))
    y = batch_norm_leaky_relu_plain(xs, valid, ss, bs, leak, eps)
    plain_chain = (y,) + torch.autograd.grad(y, (xs, ss, bs), dout)
    errs["out_rel_l2"] = _bn_rel_l2(chain[0], plain_chain[0])
    errs["dx_rel_l2"] = _bn_rel_l2(chain[1], plain_chain[1])
    errs["d_scale"] = _bn_err(chain[2], plain_chain[2])
    errs["d_bias"] = _bn_err(chain[3], plain_chain[3])
    for k in ("out_rel_l2", "dx_rel_l2", "d_scale", "d_bias"):
        check(errs[k] <= 1e-2, f"masked BN {name}: the chain's {k} off "
              f"the plain version's by {errs[k]:.3g}")
    del y, chain, plain_chain, xs, ss, bs

    def fwd():
        s = masked_sums_cuda(x, valid)
        return normalise_cuda(x, valid, s, scale, bias, leak, eps)

    def bwd():
        g, _ = masked_grad_sums_cuda(x, dout, valid, sums, scale, bias,
                                     leak, eps)
        return masked_grad_apply_cuda(x, dout, valid, sums, g, scale, bias,
                                      leak, eps)

    def both():
        fwd()
        bwd()

    xs, ss, bs = (t.clone().requires_grad_() for t in (x, scale, bias))

    def plain():
        y = batch_norm_leaky_relu_plain(xs, valid, ss, bs, leak, eps)
        torch.autograd.grad(y, (xs, ss, bs), dout)

    xv = x[:, :n_valid].reshape(-1, c).clone().requires_grad_()
    dv = dout[:, :n_valid].reshape(-1, c)

    def library():
        y = F.batch_norm(xv, None, None, ss, bs, True, 0.0, eps)
        torch.autograd.grad(F.relu(y) if leak == 0.0 else y, (xv, ss, bs),
                            dv)

    esize = 2
    least = 5 * esize * b * n_valid * c / H100_BYTES_PER_S * 1e3
    zeros = 2 * esize * b * (v - n_valid) * c / H100_BYTES_PER_S * 1e3
    dev_ms = {sym: device_ms(both, [sym], iters=20) for sym in BN_SYMBOLS}
    busy = sum(t for t in dev_ms.values() if t)
    try:
        lib_ms = round(time_ms(library, 20), 4)
    except RuntimeError as e:       # a type the library call refuses
        lib_ms = f"refused: {str(e)[:60]}"
    row = {"site": name, "B": b, "V": v, "valid": n_valid, "C": c,
           "eps": eps, "leakiness": leak,
           "errors": {k: float(f"{e:.3g}") for k, e in errs.items()},
           "fwd_ms": round(time_ms(fwd, 20), 4),
           "bwd_ms": round(time_ms(bwd, 20), 4),
           "device_ms": {k: round(t, 4) if t else t
                         for k, t in dev_ms.items()},
           "bound_ms": round(least, 4), "zeros_ms": round(zeros, 4),
           "roofline_pct": round(100 * least / busy, 2) if busy else None,
           "plain_ms": round(time_ms(plain, 5), 4), "library_ms": lib_ms}
    print("masked BN site " + json.dumps(row))
    return row


def bn_report(rows):
    """The kernels line's figures for the masked BN: the whole chain
    (forward + backward, every kernel) at the first site (seg_train's
    level 0), the largest error over the sites, and every site's row."""
    first = rows[0]
    return {"max_abs_err": max(max(r["errors"].values()) for r in rows),
            "max_abs_err_of": "the largest |twin| or |plain| (sums, "
                              "gradients of scale and bias); relative L2 "
                              "(the chain's output and dx)",
            "ms": round(first["fwd_ms"] + first["bwd_ms"], 4),
            "device_ms": first["device_ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"],
            "bound_by": "bytes: the valid rows' x and output forward, x, "
                        "gradient and dx backward",
            "library_ms": first["library_ms"],
            "library_computes": "F.batch_norm + relu over the valid rows "
                                "alone, forward and backward (timed only)",
            "site": first["site"], "sites": rows}


def bn_main():
    """``--bn``: only the masked BN kernels (csrc/masked_bn.cu) at
    :data:`BN_SITES`, after building them; prints the compiler's
    registers and spills, one line a site, the card line and the ok
    line."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from detection_3d_tpu_torch.ops import cuda_lib
    print(f"card: {card_line()}")
    t0 = time.perf_counter()
    cuda_lib.build(["masked_bn"])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    log = cuda_lib.lib_path("masked_bn").with_suffix(".log")
    for ln in log.read_text().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"  ptxas masked_bn: {ln.strip()}")
    dev = torch.device("cuda")
    cuda_lib.reset_launches()
    rows = [bn_site(*site, dev) for site in BN_SITES]
    check(cuda_lib.launches["masked_bn_dx"] > 0, "masked BN: dx did not "
          "launch")
    print(json.dumps({"masked_bn_sites": len(rows)}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# the ROI pooler's launch counters and device symbols (csrc/roi_align.cu),
# and the paths that have no ROI head
ROI_KERNELS = ("roi_align", "roi_align_bwd")
ROI_FWD, ROI_BWD = "roi_align_rotated_fwd", "roi_align_rotated_bwd"
ROI_BYPASS = ("seg_train", "rpn_only")


def _capture_pools(fn):
    """Run ``fn`` and return the arguments of every roi_align_rotated_sparse
    call pool_rois made in it: [(table, rois, roi_valid, out_size, sr,
    roi_batch)]."""
    from detection_3d_tpu_torch.models import roi_head
    calls = []
    pool = roi_head.roi_align_rotated_sparse

    def spy(table, rois, roi_valid, out_size, sr=2, roi_batch=None):
        calls.append((table, rois, roi_valid, tuple(out_size), sr,
                      roi_batch))
        return pool(table, rois, roi_valid, out_size, sr, roi_batch)

    roi_head.roi_align_rotated_sparse = spy
    try:
        fn()
    finally:
        roi_head.roi_align_rotated_sparse = pool
    return calls


def _fresh(call):
    """A captured pooler call with its tensors copied out of the forward
    (an inference tensor takes no part in autograd); the table's rows
    keep whether they took a gradient."""
    from detection_3d_tpu_torch.ops.sparse import SparseTensor
    t, rois, valid, out_size, sr, level = call
    feats = t.feats.detach().clone().requires_grad_(t.feats.requires_grad)
    t = SparseTensor(t.coords.clone(), feats, t.hi.clone(), t.lo.clone(),
                     t.num.clone(), t.spatial_size, t.batch_size,
                     t.true_num.clone(), t.keys.clone())
    return (t, rois.clone(), valid.clone(), out_size, sr,
            None if level is None else level.clone())


def roi_pools(cfg, scenes, dev, gcfg=None):
    """The pooler's arguments at the main paths' shapes, each with the
    ROI launches of the path that made it: one building served (an eager
    predict), a unit of 4 (the batched predict in table mode) and one
    3G6c training forward (its 3 groups; ``gcfg``, by default ``cfg``
    with the 3G6c groups; the table's rows take a gradient). Returns
    [(name, call, launches of the path, its pool_rois calls)]."""
    from detection_3d_tpu_torch.data.native_packer import pack_table_native
    from detection_3d_tpu_torch.data.packing import to_device
    from detection_3d_tpu_torch.engine.inference import (
        make_batch_predict_fn, make_predict_fn, pad_scene)
    from detection_3d_tpu_torch.engine.trainer import (
        batch_to_device, total_loss)
    from detection_3d_tpu_torch.models.detector import (
        SparseRCNN, voxelize_points)
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.tools.overfit_check import GROUPS_3G6C
    out = []
    model = SparseRCNN(cfg, seed=0).to(dev).eval()
    one = make_predict_fn(cfg, model, dev, graph=False)
    unit = make_batch_predict_fn(cfg, model, dev, packed="table", graph=False)
    packs = [pack_table_native(cfg, s) for s in scenes[1:5]]
    stacked = to_device({k: np.stack([p[k] for p in packs])
                         for k in packs[0]}, dev)
    batch = pad_scene(cfg, scenes[0])
    for name, fn in (("served, one building", lambda: one(batch)),
                     ("served, unit of 4", lambda: unit(stacked))):
        with torch.inference_mode():
            fn()
            cuda_lib.reset_launches()
            calls = _capture_pools(lambda: fn()[0].cpu())
        check(len(calls) == 1, f"ROI {name}: {len(calls)} pool_rois calls")
        out.append((name, _fresh(calls[0]), dict(cuda_lib.launches), 1))
    del model, one, unit
    gcfg = gcfg or cfg.replace(separate_classes=GROUPS_3G6C)
    model = SparseRCNN(gcfg, seed=0).to(dev).train()
    g = torch.Generator().manual_seed(0)
    pri = {k: torch.rand((n,), generator=g).to(dev)
           for k, n in model.priority_shapes().items()}
    (pts, fts, valid), gt, gtl = batch_to_device(pad_scene(gcfg, scenes[0]),
                                                 dev)

    def step():
        losses = model(voxelize_points(gcfg, pts, fts, valid), gt, gtl,
                       priorities=pri)
        total_loss(losses).backward()

    step()
    model.zero_grad(set_to_none=True)
    cuda_lib.reset_launches()
    calls = _capture_pools(step)
    torch.cuda.synchronize()
    check(len(calls) == model.groups, f"ROI training: {len(calls)} "
          f"pool_rois calls for {model.groups} groups")
    out.append(("3g6c training forward", _fresh(calls[0]),
                dict(cuda_lib.launches), len(calls)))
    return out


def roi_shape(name, call, launches, n_calls, dev):
    """One pooler shape: the kernel against the plain version on the
    rows in f32 (bf16: each bin within one bf16 step; the kernel on f32
    rows within 1e-5 of the largest), the backward (where the rows take
    a gradient) against the plain version's autograd in f32 within 1e-5
    of the largest, the path's launches (one forward a pool_rois call, and
    one backward on a training path), then device times by the profiler
    and CUDA events beside the plain version's (the parent's path) and
    the bounds: the bytes that must move (the output written, the table,
    its keys and the rois read once) at 3.35 TB/s, and the corner rows
    that the kernel reads from L2 (each found corner of a valid roi's
    samples, a row of C elements, counted from the backward's pairs).
    The forward's device time is its kernel's; the backward's is every
    kernel of the call (the pairs and sum kernels, and plain torch's
    sort and searchsorted between them), with the two kernels' share
    beside. A device time the profiler under-counts reads None."""
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.ops.roi_align import (
        roi_align_pairs_cuda, roi_align_plain, roi_align_rotated_sparse)
    table, rois, valid, out_size, sr, level = call
    train = table.feats.requires_grad
    table = table.with_feats(table.feats.detach())
    check(launches["roi_align"] == n_calls,
          f"ROI {name}: {launches['roi_align']} forward launches for "
          f"{n_calls} pool_rois calls")
    check(launches["roi_align_bwd"] == (n_calls if train else 0),
          f"ROI {name}: {launches['roi_align_bwd']} backward launches")
    f32 = table.with_feats(table.feats.float())

    def fwd():
        return roi_align_rotated_sparse(table, rois, valid, out_size, sr,
                                        level)

    def plain():
        return roi_align_plain(table, rois, valid, out_size, sr, level)

    with torch.no_grad():
        got = fwd()
        ref = roi_align_plain(f32, rois, valid, out_size, sr, level)
        check(torch.equal(fwd(), got), f"ROI {name}: two calls differ")
        err = (got.float() - ref).abs()
        big = ref.abs().max().clamp(min=1e-30)
        errs = {"fwd_f32": float(((roi_align_rotated_sparse(
            f32, rois, valid, out_size, sr, level) - ref).abs().max()
            / big))}
        if got.dtype == torch.bfloat16:
            excess = (err - (ref.abs() * 2 ** -7 + 1e-5 * big)).max()
            check(float(excess) <= 0, f"ROI {name}: a bin beyond one bf16 "
                  f"step of the plain version in f32 by {float(excess):.3g}")
            errs["fwd_bf16_steps"] = float((err / (ref.abs() * 2 ** -7
                                                   + 1e-5 * big)).max())
        check(errs["fwd_f32"] <= 1e-5, f"ROI {name}: the kernel on f32 rows "
              f"off the plain version by {errs['fwd_f32']:.3g} of the "
              "largest")
        check(not got.reshape(-1, *got.shape[-4:])[
            ~valid.reshape(-1)].any(), f"ROI {name}: an invalid roi pooled")
        # every corner slot of a valid roi that found its row (a missing
        # corner's and an invalid roi's slots take the row nb * V)
        t = table.stacked()
        keys = t.keys.reshape(t.units, -1).contiguous()
        rows = keys.numel()
        pair_rows, _ = roi_align_pairs_cuda(
            keys, rois.reshape(-1, 7).contiguous(),
            valid.reshape(-1).contiguous(),
            None if level is None else level.reshape(-1).to(
                torch.int32).contiguous(), t.spatial_size, out_size, sr)
        found = int((pair_rows < rows).sum())
        del pair_rows
    c, esize = got.shape[-1], got.element_size()
    n_rois = rois.numel() // 7
    least = (got.numel() * esize + table.feats.numel() * esize
             + table.keys.numel() * 8 + rois.numel() * 4)
    row = {"shape": name, "rois": n_rois, "valid_rois": int(valid.sum()),
           "table_rows": rows, "C": c, "dtype": str(got.dtype),
           "out_size": list(out_size), "sr": sr,
           "launches": {k: launches[k] for k in ("roi_align",
                                                 "roi_align_bwd")},
           "errors": {k: float(f"{e:.3g}") for k, e in errs.items()},
           "fwd_ms": round(time_ms(fwd, 20), 4),
           "fwd_device_ms": device_ms(fwd, [ROI_FWD], 20, expect=1),
           "plain_ms": round(time_ms(plain, 5), 4),
           "plain_device_ms": round(_profile(plain)["busy_ms"], 4),
           "bound_ms": round(least / H100_BYTES_PER_S * 1e3, 4),
           "bound_gb": round(least / 1e9, 4),
           "found_corner_rows": found,
           "l2_reads_gb": round(found * c * esize / 1e9, 4)}
    if train:
        fs = [t.feats.clone().requires_grad_() for t in (f32, f32, table)]
        outs = [fn(table.with_feats(f), rois, valid, out_size, sr, level)
                for fn, f in zip((roi_align_rotated_sparse, roi_align_plain,
                                  roi_align_rotated_sparse), fs)]
        cot = torch.randn(outs[0].shape, device=dev,
                          generator=torch.Generator(dev).manual_seed(0))
        before = cuda_lib.launches["roi_align_bwd"]
        d = [torch.autograd.grad(o, f, cot.to(o.dtype), retain_graph=True)[0]
             for o, f in zip(outs, fs)]
        check(cuda_lib.launches["roi_align_bwd"] == before + 2,
              f"ROI {name}: the backward did not launch once a call")
        e = float((d[0] - d[1]).abs().max() / d[1].abs().max().clamp(
            min=1e-30))
        check(e <= 1e-5, f"ROI {name}: the backward off the plain "
              f"version's autograd by {e:.3g} of the largest")
        again = torch.autograd.grad(outs[0], fs[0], cot, retain_graph=True)
        check(torch.equal(again[0], d[0]), f"ROI {name}: two backward "
              "calls differ")
        row["errors"]["bwd_f32"] = float(f"{e:.3g}")

        cot_t = cot.to(outs[2].dtype)

        def bwd():
            torch.autograd.grad(outs[2], fs[2], cot_t, retain_graph=True)

        plain_out = roi_align_plain(table.with_feats(fs[2]), rois, valid,
                                    out_size, sr, level)

        def plain_bwd():
            torch.autograd.grad(plain_out, fs[2], cot.to(plain_out.dtype),
                                retain_graph=True)

        row.update({
            "bwd_ms": round(time_ms(bwd, 20), 4),
            "bwd_device_ms": device_ms(bwd, None, 20),
            "bwd_kernels_device_ms": device_ms(bwd, [ROI_BWD], 20, expect=2),
            "plain_bwd_ms": round(time_ms(plain_bwd, 5), 4),
            # the gradient read and the rows' gradient written once
            "bwd_bound_ms": round((got.numel() + rows * c) * esize
                                  / H100_BYTES_PER_S * 1e3, 4)})
        del outs, fs, d, plain_out
    print("ROI shape " + json.dumps(row))
    torch.cuda.empty_cache()
    return row


def roi_path(cfg, scenes, dev, gcfg=None):
    """The ROI pooler (csrc/roi_align.cu) at the main paths' shapes
    (:func:`roi_pools`, :func:`roi_shape`). Returns the kernels line's
    report."""
    rows = [roi_shape(*pool, dev)
            for pool in roi_pools(cfg, scenes, dev, gcfg)]
    first = rows[0]
    errs = [e for r in rows for e in r["errors"].values()]
    train = next(r for r in rows if "bwd_ms" in r)
    return {"max_abs_err": max(errs),
            "max_abs_err_of": "the largest |plain| (f32), in bf16 steps of "
                              "each bin (bf16)",
            "ms": first["fwd_ms"], "device_ms": first["fwd_device_ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": "bytes: the output written, the table, keys and "
                        "rois read once",
            "library_ms": None, "shape": first["shape"],
            "bwd": {k: train[k] for k in ("bwd_ms", "bwd_device_ms",
                                          "bwd_kernels_device_ms",
                                          "plain_bwd_ms", "bwd_bound_ms")},
            "shapes": rows}


def roi_main():
    """``--roi``: only the ROI pooler's phase (:func:`roi_path`) at full
    width, after building the kernels; prints the compiler's registers
    and spills, one line a shape, the card line and the ok line."""
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from detection_3d_tpu_torch.config.defaults import full_scale_config
    from detection_3d_tpu_torch.data import native_packer
    from detection_3d_tpu_torch.data.synthetic import synthetic_multiroom
    from detection_3d_tpu_torch.ops import cuda_lib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_line()}")
    t0 = time.perf_counter()
    cuda_lib.build()
    native_packer.library()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    log = cuda_lib.lib_path("roi_align").with_suffix(".log")
    for ln in log.read_text().splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(f"  ptxas roi_align: {ln.strip()}")
    cfg = full_scale_config()
    scenes = [synthetic_multiroom(seed=100 + i, num_points=POINTS,
                                  rooms_xy=(5, 5), room=8.0,
                                  voxel_scale=cfg.sparse3d.voxel_scale)
              for i in range(5)]
    t0 = time.perf_counter()
    rep = roi_path(cfg, scenes, torch.device("cuda"))
    print(f"ROI phase: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"roi_align": {k: v for k, v in rep.items()
                                    if k != "shapes"}}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


MODES = {"--bwd-shapes": bwd_shapes_main, "--compare": compare_main,
         "--d-forms": d_forms_main,
         "--overfit": overfit_main, "--parallel": parallel_main,
         "--batched": batched_main, "--minkunet": minkunet_main,
         "--bn": bn_main, "--roi": roi_main}

if __name__ == "__main__":
    if len(sys.argv) > 2 or sys.argv[1:] and sys.argv[1] not in MODES:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        sys.exit(2)
    sys.exit(MODES[sys.argv[1]]() if sys.argv[1:] else main())
