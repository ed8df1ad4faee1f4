#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (detection_3d_tpu_torch) on one card.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from detection_3d_tpu_torch/csrc (one
   nvcc per source, all started together) and prints the build time.
3. Holds each kernel against its plain PyTorch version on the card, at
   the main path's shapes taken from a full-size synthetic building:
   A (gather-conv) on the scale-0 and scale-1 rulebooks in f32 and bf16,
   B (submanifold match) on the 524288-row scale-0 table, bit exact,
   C (rotated IoU) on 2000 x 2000 boxes for criteria -1/0/1/2, with the
   greedy NMS keep sets of both IoU matrices identical. Prints kernel,
   plain and bound times.
4. Drives the main path at full width — full_scale_config(), seeded
   random weights, make_predict_fn + run_inference over 4 buildings of
   500k points — and checks finite outputs, true_num > 0 and that every
   kernel's launch count grew during that run. Prints s/building for the
   buildings after the first, and a per-stage breakdown of one more.
5. Runs one small building through the kernels on the card and through
   the plain versions on the CPU; the detections must agree.
6. Prints the card line, a JSON line of per-kernel numbers and, last,
   {"ok": true, "device": {...}}.

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
            use_yaws=(1, 1, 1), fpn_pre_nms_top_n_test=256,
            fpn_post_nms_top_n_test=64),
        roi=ROIConfig(pooler_scales_from_top=(2, 1), detections_per_img=32,
                      mlp_head_dim=32),
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


def device_profile(predict, batch, kernel_names):
    """torch.profiler over one building: device busy time, the span from
    the first to the last device activity, per-kernel and top device
    times (ms). None when the profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            out, _ = predict(batch)
            out.cpu()
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
    ours = {k: sum(v for n, v in by_name.items() if f"{k}_kernel" in n)
            for k in kernel_names}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"busy_ms": busy, "span_ms": span,
            "idle_share_of_span": 1.0 - busy / span if span > 0 else None,
            "device_activities": len(evs), "port_kernels_ms": ours,
            "top_ms": [[n[:90], v] for n, v in top]}


def valid_rows(packed):
    a = packed.cpu().numpy()
    a = a[a[:, 9] > 0.5]
    return a[np.lexsort((a[:, 7], a[:, 8]))]


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
              for i in range(BUILDINGS + 1)]
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
        table1, crb, _ = downsample_with_rulebooks(
            table0, cfg.sparse3d.kernels[0], cfg.sparse3d.strides[0], caps[1])
        print(f"scale-0 table: {int(table0.num)} of {table0.capacity} rows "
              f"(true_num {int(table0.true_num)}); scale 1: "
              f"{int(table1.num)} of {table1.capacity}")
        rep_b = check_subm_match(table0)
        idx0 = neighbor_match_3x3x3(table0)
        idx1 = neighbor_match_3x3x3(table1)
        rep_a = check_gather_conv(dev, table0, table1, crb, idx0, idx1, gen)
        rep_c = check_rotated_iou(dev)
        del table0, table1, crb, idx0, idx1

    # ---- the main path at full width ------------------------------------
    model = SparseRCNN(cfg, seed=0)
    predict = make_predict_fn(cfg, model, device="cuda")
    main_scenes = scenes[:BUILDINGS]
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    preds, _, sec = run_inference(cfg, model, main_scenes, predict_fn=predict)
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    for i, p in enumerate(preds):
        check(p["true_num"] > 0, f"building {i}: true_num == 0")
        check(p["boxes"].shape[0] > 0, f"building {i}: no detections")
        check(bool(np.isfinite(p["boxes"]).all()
                   and np.isfinite(p["scores"]).all()),
              f"building {i}: non-finite detections")
    print(f"main path: {len(preds)} buildings in {wall:.2f} s, "
          f"{sec:.4f} s/building over buildings 2..{len(preds)} "
          f"(host clock, padded arrays in -> detections on host), peak "
          f"device memory {peak_gb:.2f} GiB, launches {json.dumps(launches)}")
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
    prof = device_profile(predict, pad_scene(cfg, scenes[-1]),
                          cuda_lib.KERNELS)
    print("device profile of one more building: "
          + ("not measured (the profiler recorded no device activity)"
             if prof is None else json.dumps(prof)))

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

    kernels = []
    spec = [("gather_conv", "detection_3d_tpu_torch/csrc/gather_conv.cu",
             "detection_3d_tpu/ops/pallas/gather_conv_kernel.py:245", rep_a),
            ("subm_match", "detection_3d_tpu_torch/csrc/subm_match.cu",
             "detection_3d_tpu/ops/pallas/match_kernel.py:193", rep_b),
            ("rotated_iou", "detection_3d_tpu_torch/csrc/rotated_iou.cu",
             "detection_3d_tpu/ops/pallas/rotated_iou_kernel.py:196", rep_c)]
    for name, src, replaces, rep in spec:
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": rep["max_abs_err"], "ms": rep["ms"],
                        "plain_ms": rep["plain_ms"],
                        "bound_ms": rep["bound_ms"],
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
