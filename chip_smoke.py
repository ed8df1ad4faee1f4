#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (detection_3d_tpu_torch) on one card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's five CUDA sources from detection_3d_tpu_torch/csrc
   (one nvcc per source, all started together) and prints the build time.
3. Holds each kernel against its plain PyTorch version on the card, at
   the main paths' shapes taken from a full-size synthetic building:
   A (gather-conv) and its two backward kernels A' (dFeats, dW) on the
   scale-0 and scale-1 rulebooks in f32 and bf16; B (submanifold match)
   on the 524288-row scale-0 table, bit exact; C (rotated IoU) on
   2000 x 2000 boxes for criteria -1/0/1/2 with identical greedy NMS keep
   sets, and at the training shapes (max_gt x all anchors, criterion 2;
   max_gt x proposals, criterion -1); D (query-key match) on the scale-0
   -> scale-1 conv and deconv books, bit exact against its plain version
   and the scatter-derived books. Prints kernel, plain and bound times.
4. Serving path at full width: full_scale_config(), seeded random
   weights, make_predict_fn + run_inference over 4 buildings of 500k
   points; checks finite outputs, true_num > 0 and that every serving
   kernel was launched. Prints s/building and a breakdown of one more.
5. Training path at full width: a Trainer on the card takes 6 steps over
   6 such buildings (bf16 compute, SparseRCNN(cfg, seed=0)); checks
   finite losses, applied steps, moved parameters and that A, both A'
   kernels, B and C were launched. Prints s/step, peak memory, the losses
   of each step and a device profile of one more step.
6. D's own path: conv_rulebook_match / deconv_rulebook_match over every
   downsample of a full-size building's pyramid, bit exact against the
   scatter-derived books.
7. Small inputs, card against CPU: one building through predict, and one
   training step with the same weights and sampler draws (losses and
   every gradient).
8. Prints the card line, a JSON line of per-kernel numbers and, last,
   {"ok": true, "device": {...}}.

Launch counts are set to 0 just before each path and read just after;
launches made to compare a kernel with its plain version do not count.
Any failed phase raises and exits non-zero; without CUDA, or without the
package beside it, the script exits non-zero before printing a result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense, /s
SCALAR_OPS = 67e12               # f32 outside the tensor cores
# per-pair scalar operations of kernel C, counted from csrc/rotated_iou.cu:
# corners 52, point-in-quad 176, edge intersections 784, centroid 98,
# keys 264, ranks 1656, successor search 1272, criteria ~10
IOU_OPS_PER_PAIR = 4312
BUILDINGS = 4            # the first warms up, the other three are timed
TRAIN_STEPS = 6          # the first warms up, the other five are timed
POINTS = 500_000         # per synthetic building (bench.py's smoke size)


def check(ok, msg):
    if not ok:
        raise RuntimeError(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def check_gather_conv(dev, table0, table1, crb, idx0, idx1, gen):
    """Kernel A against gather_conv on the card at main-path shapes; the
    bf16 scale-0 32->32 case (the backbone's commonest) is reported."""
    from detection_3d_tpu_torch.ops.sparse_conv import (
        gather_conv, gather_conv_cuda)
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
            got = gather_conv_cuda(feats, idx, w, valid).float()
            want = gather_conv(feats, idx, w, valid).float()
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            tol = (1e-4 if dtype == torch.float32 else 1e-2) * max(scale, 1.0)
            check(err <= tol, f"kernel A {name} {dtype}: max abs err {err} "
                  f"> {tol}")
            ms = time_ms(lambda: gather_conv_cuda(feats, idx, w, valid))
            plain = time_ms(lambda: gather_conv(feats, idx, w, valid), 3)
            eb = feats.element_size()
            nnz = int(((idx < tin.capacity) & valid[None, :]).sum())
            nbytes = (tin.capacity * cin * eb + idx.numel() * 4
                      + k * cin * cout * eb + valid.numel()
                      + valid.numel() * cout * eb)
            b_ms, b_by = bound(nbytes, 2.0 * nnz * cin * cout,
                               PEAK_OPS[dtype])
            line = {"case": name, "dtype": str(dtype).split(".")[-1],
                    "K": k, "V_in": tin.capacity, "V_out": tout.capacity,
                    "max_abs_err": err, "tolerance": tol, "ms": ms,
                    "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by}
            print("kernel A", json.dumps(line))
            if name == "s0 subm 32->32" and dtype == torch.bfloat16:
                report = line
    return report


def check_gather_conv_bwd(dev, table0, table1, crb, idx0, idx1, gen):
    """The two backward kernels against gather_conv_backward at the four
    main-path shapes of kernel A, f32 and bf16, with a random upstream
    gradient. The bf16 scale-0 32->32 case is reported.

    Tolerance 1e-4 (f32) and 1e-2 (bf16) of the largest wanted value:
    both sides sum in f32, the kernels with atomics in an order that
    changes from run to run, and bf16 results differ by one rounding."""
    from detection_3d_tpu_torch.ops.sparse_conv import (
        gather_conv_backward, gather_conv_dfeats_cuda, gather_conv_dw_cuda)
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
            got_f = gather_conv_dfeats_cuda(feats, idx, w, valid, g)
            got_w = gather_conv_dw_cuda(feats, idx, w, valid, g)
            errs = {}
            for part, got, want in (("dfeats", got_f, want_f),
                                    ("dw", got_w, want_w)):
                err = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                tol = (1e-4 if dtype == torch.float32 else 1e-2) * \
                    max(scale, 1e-30)
                check(err <= tol, f"kernel A' {part} {name} {dtype}: max "
                      f"abs err {err} > {tol}")
                errs[part] = (err, tol)
            ms_f = time_ms(lambda: gather_conv_dfeats_cuda(feats, idx, w,
                                                           valid, g))
            ms_w = time_ms(lambda: gather_conv_dw_cuda(feats, idx, w, valid,
                                                       g))
            plain = time_ms(lambda: gather_conv_backward(feats, idx, w,
                                                         valid, g), 3)
            eb = feats.element_size()
            nnz = int(((idx < tin.capacity) & valid[None, :]).sum())
            ops = 2.0 * nnz * cin * cout
            idx_b = idx.numel() * 4 + valid.numel()
            g_b = tout.capacity * cout * eb
            f_b = tin.capacity * cin * eb
            w_b = k * cin * cout * eb
            # dFeats reads g, idx, W and writes dFeats; dW reads feats,
            # g, idx and writes dW
            bf = bound(g_b + idx_b + w_b + f_b, ops, PEAK_OPS[dtype])
            bw = bound(f_b + g_b + idx_b + w_b, ops, PEAK_OPS[dtype])
            for part, ms, (b_ms, b_by) in (("dfeats", ms_f, bf),
                                           ("dw", ms_w, bw)):
                line = {"case": name, "part": part,
                        "dtype": str(dtype).split(".")[-1], "K": k,
                        "V_in": tin.capacity, "V_out": tout.capacity,
                        "nnz": nnz, "max_abs_err": errs[part][0],
                        "tolerance": errs[part][1], "ms": ms,
                        "plain_ms": plain, "plain_computes": "both parts",
                        "bound_ms": b_ms, "bound_by": b_by}
                print("kernel A'", json.dumps(line))
                if name == "s0 subm 32->32" and dtype == torch.bfloat16:
                    report[part] = line
    return report


def check_multi_match(table0, table1, crb, drb):
    """Kernel D against its plain version and the scatter-derived books,
    bit exact, on the full-size scale-0 -> scale-1 tables."""
    from detection_3d_tpu_torch.ops.coords import (
        INVALID, composite_key, pack_key)
    from detection_3d_tpu_torch.ops.multi_match import (
        conv_rulebook_match, deconv_rulebook_match, multi_match_cuda,
        multi_match_plain)
    k2 = (2, 2, 2)
    got_c = conv_rulebook_match(table1, table0, k2, k2)
    got_d = deconv_rulebook_match(table0, table1, k2, k2)
    check(torch.equal(got_c, crb), "kernel D: conv book differs from the "
          "scatter-derived book")
    check(torch.equal(got_d, drb), "kernel D: deconv book differs from the "
          "scatter-derived book")
    # the conv book's queries, as conv_rulebook_match builds them
    st = torch.tensor([2, 2, 2, 1], dtype=torch.int32, device=table1.device)
    deltas = torch.tensor([[a, b, c, 0] for a in range(2) for b in range(2)
                           for c in range(2)], dtype=torch.int32,
                          device=st.device)
    qhi, qlo = pack_key((table1.coords * st)[None] + deltas[:, None],
                        table0.spatial_size,
                        valid=table1.row_valid[None, :])
    q = composite_key(qhi, qlo).reshape(-1)
    got = multi_match_cuda(table0.keys, q)
    want = multi_match_plain(table0.keys, q)
    check(torch.equal(got, want), "kernel D differs from multi_match_plain")
    ms = time_ms(lambda: multi_match_cuda(table0.keys, q))
    plain = time_ms(lambda: multi_match_plain(table0.keys, q), 3)
    v, n = table0.capacity, q.numel()
    searches = int((qhi != INVALID).sum())
    probes = max(1, (v - 1).bit_length()) + 1
    b_ms, b_by = bound(v * 8 + n * 8 + n * 4, 4.0 * probes * searches,
                       SCALAR_OPS)
    line = {"V": v, "queries": n, "searches": searches,
            "found": int((got < v).sum()), "max_abs_err": 0.0,
            "tolerance": "bit exact", "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by}
    print("kernel D", json.dumps(line))
    return line


def check_subm_match(table0):
    """Kernel B against neighbor_indices, bit exact, on the scale-0 table."""
    from detection_3d_tpu_torch.ops.sparse import (
        neighbor_indices, neighbor_match_3x3x3, submanifold_offsets)
    offs = submanifold_offsets((3, 3, 3))
    got = neighbor_match_3x3x3(table0)
    want = neighbor_indices(table0, offs)
    check(torch.equal(got, want), "kernel B differs from neighbor_indices")
    ms = time_ms(lambda: neighbor_match_3x3x3(table0))
    plain = time_ms(lambda: neighbor_indices(table0, offs), 3)
    v = table0.capacity
    num = int(table0.num)
    found = int((got[:, :num] < v).sum())
    # searches this table needs: valid sites x in-grid offsets, each a
    # lower bound of ceil(log2 V) + 1 probes of ~4 operations
    c = table0.coords[:num]
    size = torch.tensor(table0.spatial_size, device=c.device)
    searches = sum(int(((c[:, :3] + torch.tensor(o, device=c.device) >= 0)
                        & (c[:, :3] + torch.tensor(o, device=c.device)
                           < size)).all(1).sum()) for o in offs)
    probes = max(1, (v - 1).bit_length()) + 1
    nbytes = v * 8 + v * 16 + 4 + 27 * v * 4
    b_ms, b_by = bound(nbytes, 4.0 * probes * searches, SCALAR_OPS)
    line = {"V": v, "num": num, "searches": searches, "found": found,
            "max_abs_err": 0.0,
            "tolerance": "bit exact",
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}
    print("kernel B", json.dumps(line))
    return line


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


def check_rotated_iou(dev):
    """Kernel C against rotated_iou_plain at 2000 x 2000, criteria
    -1/0/1/2, and greedy NMS keep sets of both matrices."""
    from detection_3d_tpu_torch.ops.nms import greedy_suppress
    from detection_3d_tpu_torch.ops.rotated_iou import (
        rotated_iou_cuda, rotated_iou_plain, z_interval_iou)
    n = 2000
    boxes = torch.from_numpy(_nms_boxes_np(n, 0)).to(dev)
    bev = boxes[:, [0, 1, 3, 4, 6]].contiguous()
    errs, report = {}, None
    for crit in (-1, 0, 1, 2):
        got = rotated_iou_cuda(bev, bev, crit)
        want = rotated_iou_plain(bev, bev, crit)
        both = torch.isfinite(got) == torch.isfinite(want)
        check(bool(both.all()), f"kernel C criterion {crit}: non-finite "
              "entries differ")
        fin = torch.isfinite(want)
        errs[crit] = float((got[fin] - want[fin]).abs().max())
        check(errs[crit] <= 1e-5, f"kernel C criterion {crit}: max abs err "
              f"{errs[crit]} > 1e-5")
        if crit == -1:
            iouz = z_interval_iou(boxes[:, [2, 5]], boxes[:, [2, 5]])
            valid = torch.ones(n, dtype=torch.bool, device=dev)
            k_keep = greedy_suppress(got * iouz > 0.5, valid, 1000)
            p_keep = greedy_suppress(want * iouz > 0.5, valid, 1000)
            check(torch.equal(k_keep[0], p_keep[0]),
                  "kernel C: NMS keep sets differ from the plain version")
            t0 = time.perf_counter()
            greedy_suppress(got * iouz > 0.5, valid, 1000)
            greedy_ms = (time.perf_counter() - t0) * 1e3
            ms = time_ms(lambda: rotated_iou_cuda(bev, bev, crit))
            plain = time_ms(lambda: rotated_iou_plain(bev, bev, crit), 2)
            b_ms, b_by = bound(2 * n * 5 * 4 + n * n * 4,
                               float(IOU_OPS_PER_PAIR) * n * n, SCALAR_OPS)
            report = {"N": n, "K": n, "kept": int(k_keep[1]), "ms": ms,
                      "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                      "greedy_host_ms": greedy_ms}
    report["max_abs_err"] = max(errs.values())
    report["tolerance"] = 1e-5
    report["max_abs_err_by_criterion"] = errs
    print("kernel C", json.dumps(report))
    return report


def check_rotated_iou_training(cfg, table0, batch):
    """Kernel C at the training shapes: criterion 2 between max_gt gt
    boxes and every anchor of a full-size building (RPN targets), and
    criterion -1 between max_gt gt boxes and post-NMS + max_gt proposals
    (ROI targets), both with the label thickness floors. The full RPN
    call is timed; the plain version holds all gt rows against a spread
    slice of 4096 anchor columns (the full plain matrix does not fit)."""
    from detection_3d_tpu_torch.models.anchors import generate_anchors
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.ops.rotated_iou import (
        rotated_iou_cuda, rotated_iou_plain)
    dev = table0.device
    pyr = build_pyramid(table0, cfg)
    n = cfg.sparse3d.num_scales
    slots = cfg.rpn.rpn_scales_from_top
    maps = []
    for i in cfg.rpn.rpn_3d_2d_selector:
        slot = i % len(slots)
        maps.append(pyr["tables"][n - 1 - slots[slot]] if i < len(slots)
                    else pyr["bev"][slot][0])
    anchors = generate_anchors(cfg, maps)
    gt = torch.as_tensor(batch["gt_boxes"]).to(dev)

    def bev(boxes, y_floor):
        b = boxes[:, [0, 1, 3, 4, 6]].clone()
        b[:, 2] = torch.clamp(b[:, 2], min=y_floor)
        return b.contiguous()

    gt_rpn = bev(gt, cfg.rpn.label_aug_thickness_y_tar_anc[0])
    anc = bev(anchors.boxes, cfg.rpn.label_aug_thickness_y_tar_anc[1])
    n_anchors = anc.shape[0]
    full = rotated_iou_cuda(gt_rpn, anc, 2)
    check(bool(torch.isfinite(full).all()), "kernel C (training): "
          "non-finite IoU at 512 x anchors")
    cols = torch.linspace(0, n_anchors - 1, 4096, device=dev).long()
    want = rotated_iou_plain(gt_rpn, anc[cols], 2)
    err_rpn = float((full[:, cols] - want).abs().max())
    check(err_rpn <= 1e-5, f"kernel C criterion 2 at the training shape: "
          f"max abs err {err_rpn}")
    ms = time_ms(lambda: rotated_iou_cuda(gt_rpn, anc, 2), 5)
    m = gt_rpn.shape[0]
    b_ms, b_by = bound(2 * 5 * 4 * (m + n_anchors) + m * n_anchors * 4,
                       float(IOU_OPS_PER_PAIR) * m * n_anchors, SCALAR_OPS)
    # ROI targets: max_gt x (post-NMS top-n + max_gt) proposals, here the
    # first anchors standing in for proposals
    r = cfg.rpn_post_nms_top_n_train + cfg.caps.max_gt
    gt_roi = bev(gt, cfg.roi.label_aug_thickness_y_tar_anc[0])
    props = bev(anchors.boxes[:r], cfg.roi.label_aug_thickness_y_tar_anc[1])
    got_roi = rotated_iou_cuda(gt_roi, props, -1)
    err_roi = float((got_roi - rotated_iou_plain(gt_roi, props, -1))
                    .abs().max())
    check(err_roi <= 1e-5, f"kernel C criterion -1 at the ROI training "
          f"shape: max abs err {err_roi}")
    ms_roi = time_ms(lambda: rotated_iou_cuda(gt_roi, props, -1))
    line = {"rpn": {"N": m, "K": n_anchors, "criterion": 2,
                    "max_abs_err_on_4096_columns": err_rpn, "ms": ms,
                    "bound_ms": b_ms, "bound_by": b_by},
            "roi": {"N": m, "K": r, "criterion": -1,
                    "max_abs_err": err_roi, "ms": ms_roi},
            "tolerance": 1e-5,
            "anchors": n_anchors}
    print(f"anchors of one full-size building: {n_anchors} "
          f"({[t.capacity for t in maps]} map rows x "
          f"{cfg.rpn.num_anchors_per_location})")
    print("kernel C (training shapes)", json.dumps(line))
    return line


# each launch counter's kernel symbols in a device trace (the backward
# entries' casts to bf16 run as cast_kernel)
SYMBOLS = {"gather_conv": "gather_conv_kernel", "gather_conv_dfeats":
           "dfeats_kernel", "gather_conv_dw": "dw_kernel",
           "gather_conv_bwd_cast": "cast_kernel",
           "subm_match": "subm_match_kernel",
           "rotated_iou": "rotated_iou_kernel",
           "multi_match": "multi_match_kernel"}


def _profile(fn):
    """torch.profiler over one call of ``fn``: device busy time, the span
    from the first to the last device activity, per-kernel and top device
    times (ms). None when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    evs = [e for e in prof.events()
           if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not evs:
        return None
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    span = (max(e.time_range.end for e in evs)
            - min(e.time_range.start for e in evs)) / 1e3
    ours = {k: sum(v for n, v in by_name.items() if sym in n)
            for k, sym in SYMBOLS.items()}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"busy_ms": busy, "span_ms": span,
            "idle_share_of_span": 1.0 - busy / span if span > 0 else None,
            "device_activities": len(evs), "port_kernels_ms": ours,
            "top_ms": [[n[:90], v] for n, v in top]}


def device_profile(predict, batch):
    """:func:`_profile` over one building of the serving path."""
    def run():
        with torch.inference_mode():
            out, _ = predict(batch)
            out.cpu()
    return _profile(run)


def valid_rows(packed):
    a = packed.cpu().numpy()
    a = a[a[:, 9] > 0.5]
    return a[np.lexsort((a[:, 7], a[:, 8]))]


def train_path(cfg, scenes, dev):
    """The training path at full width: a Trainer on the card takes
    TRAIN_STEPS steps (one epoch over TRAIN_STEPS buildings), with launch
    counts set to 0 just before and read just after. Then one more step
    under the profiler. Returns (launches, report)."""
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
    report = {"steps": len(secs), "applied": state.solver.count,
              "s_per_step": sec, "step_seconds": secs, "wall_s": wall,
              "peak_device_memory_gib": peak_gb,
              "parameters_moved": moved,
              "parameters": len(before),
              "losses": [h[1] for h in trainer.history]}
    print("training path:", json.dumps(report))
    print(f"training path: {sec:.4f} s/step over steps 2..{len(secs)} "
          f"(host clock, synchronised: padded arrays in -> losses on the "
          f"host, backward and update included), peak device memory "
          f"{peak_gb:.2f} GiB, launches {json.dumps(launches)}")
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = pad_scene(cfg, scenes[-1])
    prof = _profile(lambda: trainer.step(state, batch, gen))
    print("device profile of one more training step: "
          + ("not measured (the profiler recorded no device activity)"
             if prof is None else json.dumps(prof)))
    del trainer, state, before
    shutil.rmtree(out_dir, ignore_errors=True)
    return launches, report


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
        up_by_scale = pyr["up_rb"][::-1]
        for k, (c, d) in enumerate(books):
            check(torch.equal(c, pyr["down_rb"][k]),
                  f"kernel D path: conv book {k} differs")
            check(torch.equal(d, up_by_scale[k]),
                  f"kernel D path: deconv book {k} differs")
    check(launches["multi_match"] == 2 * (s3d.num_scales - 1),
          "kernel D path: launch count")
    print(f"kernel D path: {len(books)} conv + {len(books)} deconv books of "
          f"one full-size pyramid equal the scatter-derived books, "
          f"launches {json.dumps(launches)}")
    return launches


def tiny_train_card_vs_cpu(tcfg, scene, card="cuda"):
    """One training step at the tiny config on the CPU (plain versions)
    and on the card (kernels), same weights and sampler draws. Losses
    within 1e-4; each gradient within 1e-3 of its largest entry + 1e-5
    (the card sums in other orders, the backward kernels with atomics,
    through ~40 layers and batch norms)."""
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
    check(loss_err <= 1e-4, f"tiny training step: losses differ card vs "
          f"CPU by {loss_err}: {l_gpu} vs {l_cpu}")
    worst, worst_name = 0.0, None
    for n, want in g_cpu.items():
        got = g_gpu[n]
        check((got is None) == (want is None), f"tiny training step: "
              f"gradient of {n} present on one side only")
        if want is None:
            continue
        err = float((got - want).abs().max())
        tol = 1e-3 * float(want.abs().max()) + 1e-5
        check(err <= tol, f"tiny training step: gradient {n} max abs err "
              f"{err} > {tol}")
        rel = err / tol
        if rel > worst:
            worst, worst_name = rel, n
    print(f"tiny training step: losses agree card vs CPU (max abs err "
          f"{loss_err:.2e}, tolerance 1e-4): {json.dumps(l_gpu)}; "
          f"{len(g_cpu)} gradients agree, worst at {worst:.3f} of its "
          f"tolerance ({worst_name})")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from detection_3d_tpu_torch.config.defaults import full_scale_config
    from detection_3d_tpu_torch.data.synthetic import (
        synthetic_building, synthetic_multiroom)
    from detection_3d_tpu_torch.engine.inference import (
        make_predict_fn, pad_scene, run_inference)
    from detection_3d_tpu_torch.models.detector import (
        SparseRCNN, voxelize_points)
    from detection_3d_tpu_torch.ops import cuda_lib
    from detection_3d_tpu_torch.ops.sparse import (
        downsample_with_rulebooks, neighbor_match_3x3x3)
    from detection_3d_tpu_torch.utils.timing import PhaseTimer

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    per_src = cuda_lib.build()
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(per_src)} sources in parallel "
          + json.dumps({k: round(v, 1) for k, v in per_src.items()}))
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
              for i in range(max(BUILDINGS, TRAIN_STEPS) + 1)]
    print(f"generated {len(scenes)} buildings in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- kernels against their plain versions, main-path shapes --------
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        batch = pad_scene(cfg, scenes[0])
        table0 = voxelize_points(cfg, *(torch.as_tensor(batch[k]).to(dev)
                                        for k in ("points", "feats",
                                                  "points_valid")))
        caps = cfg.caps.scale_caps(cfg.sparse3d.num_scales)
        table1, crb, drb = downsample_with_rulebooks(
            table0, cfg.sparse3d.kernels[0], cfg.sparse3d.strides[0], caps[1])
        print(f"scale-0 table: {int(table0.num)} of {table0.capacity} rows "
              f"(true_num {int(table0.true_num)}); scale 1: "
              f"{int(table1.num)} of {table1.capacity}")
        rep_b = check_subm_match(table0)
        idx0 = neighbor_match_3x3x3(table0)
        idx1 = neighbor_match_3x3x3(table1)
        rep_a = check_gather_conv(dev, table0, table1, crb, idx0, idx1, gen)
        rep_ab = check_gather_conv_bwd(dev, table0, table1, crb, idx0, idx1,
                                       gen)
        rep_d = check_multi_match(table0, table1, crb, drb)
        rep_c = check_rotated_iou(dev)
        rep_c["training_shapes"] = check_rotated_iou_training(cfg, table0,
                                                              batch)
        del table0, table1, crb, drb, idx0, idx1
    torch.cuda.empty_cache()

    # ---- the serving path at full width ---------------------------------
    model = SparseRCNN(cfg, seed=0)
    predict = make_predict_fn(cfg, model, device="cuda")
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

    phases = PhaseTimer(dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        out, _ = predict(pad_scene(cfg, scenes[-1]), phases)
        out.cpu()
    print(f"stages of one more building (synchronised, "
          f"{time.perf_counter() - t0:.3f} s total): "
          + json.dumps({k: round(v, 4) for k, v in phases.seconds.items()}))
    prof = device_profile(predict, pad_scene(cfg, scenes[-1]))
    print("device profile of one more building: "
          + ("not measured (the profiler recorded no device activity)"
             if prof is None else json.dumps(prof)))
    del model, predict
    torch.cuda.empty_cache()

    # ---- the training path at full width --------------------------------
    train, rep_train = train_path(cfg, scenes, dev)
    torch.cuda.empty_cache()

    # ---- kernel D's own entry points ------------------------------------
    match = match_path(cfg, scenes[0], dev)

    # ---- small-input reference: kernels on the card vs plain on the CPU -
    tcfg = tiny_config()
    scene = synthetic_building(seed=0, num_points=6000, room=6.0,
                               classes=tcfg.classes, voxel_scale=20)
    tmodel = SparseRCNN(tcfg, seed=0)
    tb = pad_scene(tcfg, scene)
    cpu_out, cpu_tn = make_predict_fn(tcfg, tmodel, device="cpu")(tb)
    gpu_out, gpu_tn = make_predict_fn(tcfg, tmodel, device="cuda")(tb)
    want, got = valid_rows(cpu_out), valid_rows(gpu_out)
    check(int(cpu_tn) == int(gpu_tn), "small building: true_num differs")
    check(got.shape == want.shape and want.shape[0] > 0,
          f"small building: {got.shape[0]} valid rows on the card, "
          f"{want.shape[0]} on the CPU")
    check(np.array_equal(got[:, 8], want[:, 8]), "small building: labels")
    small_err = float(np.abs(got[:, :8] - want[:, :8]).max())
    check(small_err <= 1e-4, f"small building: max abs err {small_err}")
    print(f"small building: {want.shape[0]} detections agree card vs CPU "
          f"(max abs err {small_err:.2e}, tolerance 1e-4)")
    tiny_train_card_vs_cpu(tcfg, scene)

    # launches: each kernel's count on the path it serves (training for
    # A, A', B, C; D's own entry points for D); every path's count beside
    pg = "detection_3d_tpu/ops/pallas/"
    spec = [("gather_conv", "gather_conv.cu",
             pg + "gather_conv_kernel.py:245", rep_a, train),
            ("gather_conv_dfeats", "gather_conv_bwd.cu",
             pg + "gather_conv_kernel.py:308", rep_ab["dfeats"], train),
            ("gather_conv_dw", "gather_conv_bwd.cu",
             pg + "gather_conv_kernel.py:308", rep_ab["dw"], train),
            ("subm_match", "subm_match.cu", pg + "match_kernel.py:193",
             rep_b, train),
            ("rotated_iou", "rotated_iou.cu",
             pg + "rotated_iou_kernel.py:196", rep_c, train),
            ("multi_match", "multi_match.cu", pg + "match_kernel.py:399",
             rep_d, match)]
    kernels = []
    for name, src, replaces, rep, path in spec:
        kernels.append({
            "name": name, "route": "cuda",
            "source": "detection_3d_tpu_torch/csrc/" + src,
            "replaces": replaces, "launches": path[name],
            "launches_by_path": {"serve": serve[name], "train": train[name],
                                 "match": match[name]},
            "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
            "plain_ms": rep["plain_ms"], "bound_ms": rep["bound_ms"],
            "bound_by": rep["bound_by"], "library_ms": None})
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
