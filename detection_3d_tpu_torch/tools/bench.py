"""Serving benchmark of the port on one card: s/building at the
reference's scale.

    python -m detection_3d_tpu_torch.tools.bench [--small | --parity]
        [--device cuda|cpu] [--buildings N]

Counterpart of the repo-level bench.py. The default run serves
full_scale_config() (the reference's 6c_Fpn4321: a 4096 x 4096 x 512
grid, 9 scales, 6 classes) with seeded random weights (SparseRCNN(cfg,
seed=0)) on synthetic_multiroom buildings of 500k points (5 x 5 rooms of
8 m):

1. host pack: one warm-up and one timed C++ pack_pyramid_native of the
   building (seed 0), by the host clock;
2. device time: 5 sequential make_predict_fn(packed="pyramid") calls on
   that building under torch.profiler (utils/profiling.device_activity):
   ``device_s`` is the device's busy time per building (the union of the
   device activities over every stream), ``idle_share`` beside it;
3. stream: N distinct buildings (seeds 100 .. 100 + N - 1) through
   run_inference(pipelined=True, pack_workers=2) in "table" and in
   "pyramid" mode, each after a warm-up on the held-out building: wall
   s/building and its ``timings`` per building; then the same buildings
   at batch_size 2 and 4 through make_batch_predict_fn(packed="table"),
   in buildings/s. The headline is the faster mode.

Prints ONE JSON line with the keys of bench.py's line under the same
names (:data:`LINE_KEYS`, metric "e2e_sec_per_building_fullscale_stream")
and beside them ``device`` (the card's name), ``power_limit_w``,
``idle_share``, ``peak_gib`` (peak device memory), ``n_buildings`` and
``launches`` (each streamed run's kernel wrapper calls,
ops/cuda_lib.launches: on the card a replayed CUDA graph calls none, so
a timed run counts the unit that captured its graph). ``vs_baseline`` is
4.75 s / value: 4.75 s a building is the reference's published GPU
figure (BASELINE.md), not a measurement on this card.

``--small`` takes small_config() on synthetic_building(seed=0,
num_points=100_000, room=10.0), runs steps 1-2 and prints the
``inference_sec_per_building`` line (value = device_s).

``--parity`` holds the kernels against their plain versions on the card
at the three largest scales of the full-scale building: kernel B's
submanifold book bit exact against neighbor_indices' search, kernel A on
that book against the plain gather_conv (bf16, 32 -> 32), and the
scatter-derived strided and deconv books bit exact against
conv_rulebook / deconv_rulebook (kernel D). Prints {"parity": "OK"}, or
the failures and exits 1.

Runs on the card; ``--device cpu`` runs the same at the same config on
the CPU with the plain kernels, where device_s, idle_share, peak_gib and
power_limit_w are null (not measured) and device is "cpu". Without a
card the default raises. Any failure raises, and the tool exits
non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

BASELINE_S = 4.75        # the reference's s/building on one GPU (BASELINE.md)
DEVICE_ITERS = 5
PACK_WORKERS = 2
MODES = ("table", "pyramid")
BATCH_SIZES = (2, 4)
STREAM_SEED = 100
N_STREAM = 8
# the keys of the JAX package's bench.py line (bench.py:364-391)
LINE_KEYS = ("metric", "value", "unit", "vs_baseline", "device_s",
             "stream_mode", "stream_table_s", "stream_pyramid_s",
             "stream_wait_pack_s", "stream_dispatch_s",
             "stream_drain_fetch_s", "host_pack_pyramid_s", "host_cpus",
             "batch_throughput_bps", "batch_size")
# the keys this tool adds beside them
EXTRA_KEYS = ("device", "power_limit_w", "idle_share", "peak_gib",
              "n_buildings", "launches")


def building(cfg, seed: int, small: bool = False):
    """The bench's building: synthetic_multiroom (500k points, 5 x 5 rooms
    of 8 m), or with ``small`` synthetic_building (100k points, 10 m)."""
    from detection_3d_tpu_torch.data.synthetic import (
        synthetic_building, synthetic_multiroom)
    vs = cfg.sparse3d.voxel_scale
    if small:
        return synthetic_building(seed=seed, num_points=100_000, room=10.0,
                                  voxel_scale=vs)
    return synthetic_multiroom(seed=seed, num_points=500_000,
                               rooms_xy=(5, 5), room=8.0, voxel_scale=vs)


def device_time(cfg, model, scene, device="cuda", iters=DEVICE_ITERS):
    """Steps 1-2 of the module docstring: {host_pack_pyramid_s, device_s,
    idle_share, busy_ms, sum_ms}; the device fields None on the CPU."""
    from detection_3d_tpu_torch.data.native_packer import pack_pyramid_native
    from detection_3d_tpu_torch.data.packing import to_device
    from detection_3d_tpu_torch.engine.inference import make_predict_fn
    from detection_3d_tpu_torch.utils.device import resolve_device
    from detection_3d_tpu_torch.utils.profiling import device_activity
    dev = resolve_device(device)
    pack_pyramid_native(cfg, scene)      # builds the library, warms caches
    t0 = time.perf_counter()
    packed = pack_pyramid_native(cfg, scene)
    t_pack = time.perf_counter() - t0
    print(f"host pack_pyramid (C++): {t_pack:.4f} s/building", file=sys.stderr)
    batch = to_device(packed, dev)
    predict = make_predict_fn(cfg, model, dev, packed="pyramid")
    predict(batch)[0].cpu()              # warm-up

    def run():
        for _ in range(iters):
            out, _ = predict(batch)
        out.cpu()

    act = device_activity(run, dev)
    busy = act["busy_ms"]
    return {"host_pack_pyramid_s": t_pack,
            "device_s": None if busy is None else busy / iters / 1e3,
            "idle_share": act["idle_share"], "busy_ms": busy,
            "sum_ms": act["sum_ms"]}


def _timed_stream(cfg, model, scenes, warm, dev, mode, batch_size, predict):
    """One warm-up run on ``warm`` and one timed run over ``scenes``:
    (wall s, timings, predictions, wrapper calls of the timed run)."""
    from detection_3d_tpu_torch.engine.inference import run_inference
    from detection_3d_tpu_torch.ops import cuda_lib
    kw = dict(device=dev, pipelined=True, pack_workers=PACK_WORKERS,
              pack_mode=mode, batch_size=batch_size, predict_fn=predict)
    run_inference(cfg, model, [warm] * batch_size, **kw)
    tm = {}
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    preds, _, _ = run_inference(cfg, model, scenes, timings=tm, **kw)
    wall = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    empty = [i for i, p in enumerate(preds) if p["boxes"].shape[0] == 0]
    if empty:
        raise RuntimeError(f"stream {mode} batch {batch_size}: no "
                           f"detections for buildings {empty}")
    return wall, tm, preds, launches


def stream(cfg, model, scenes, warm, device="cuda",
           batch_sizes=BATCH_SIZES):
    """Step 3 of the module docstring over ``scenes``, each run after a
    warm-up on ``warm``. Returns {"s_per_building": {mode: s},
    "timings": {mode: {wait_pack, dispatch, drain_fetch} per building},
    "bps": {batch size: buildings/s}, "preds": {run: predictions},
    "launches": {run: kernel wrapper calls}}, the runs named "table",
    "pyramid" and "batch_{B}"."""
    from detection_3d_tpu_torch.engine.inference import (
        make_batch_predict_fn, make_predict_fn)
    from detection_3d_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    n = len(scenes)
    out = {"s_per_building": {}, "timings": {}, "bps": {}, "preds": {},
           "launches": {}}
    for mode in MODES:
        wall, tm, preds, ln = _timed_stream(
            cfg, model, scenes, warm, dev, mode, 1,
            make_predict_fn(cfg, model, dev, packed=mode))
        out["s_per_building"][mode] = wall / n
        out["timings"][mode] = {k: v / n for k, v in tm.items()}
        out["preds"][mode], out["launches"][mode] = preds, ln
        print(f"stream e2e [{mode:7s}]: {wall / n:.4f} s/building ({n} "
              "buildings, wall clock), per building "
              + " ".join(f"{k}={v:.4f}s"
                         for k, v in out["timings"][mode].items()),
              file=sys.stderr)
    for bs in batch_sizes:
        wall, _, preds, ln = _timed_stream(
            cfg, model, scenes, warm, dev, "table", bs,
            make_batch_predict_fn(cfg, model, dev, packed="table"))
        out["bps"][bs] = n / wall
        out["preds"][f"batch_{bs}"] = preds
        out["launches"][f"batch_{bs}"] = ln
        print(f"batched stream B={bs}: {n / wall:.4f} buildings/s "
              f"({wall / n:.4f} s/building amortized)", file=sys.stderr)
    return out


def bench_line(dt, streamed, card, peak_gib, n_buildings):
    """The JSON line of the default run (:data:`LINE_KEYS` and
    :data:`EXTRA_KEYS`) from :func:`device_time` and :func:`stream`."""
    res = streamed["s_per_building"]
    best = min(res, key=res.get)
    e2e, bd = res[best], streamed["timings"][best]
    batch_bps, batch_size = 1.0 / res["table"], 1
    for bs, bps in streamed["bps"].items():
        if bps > batch_bps:
            batch_bps, batch_size = bps, bs
    return {
        "metric": "e2e_sec_per_building_fullscale_stream",
        "value": e2e, "unit": "s", "vs_baseline": BASELINE_S / e2e,
        "device_s": dt["device_s"], "stream_mode": best,
        "stream_table_s": res["table"], "stream_pyramid_s": res["pyramid"],
        "stream_wait_pack_s": bd["wait_pack"],
        "stream_dispatch_s": bd["dispatch"],
        "stream_drain_fetch_s": bd["drain_fetch"],
        "host_pack_pyramid_s": dt["host_pack_pyramid_s"],
        "host_cpus": os.cpu_count(),
        "batch_throughput_bps": batch_bps, "batch_size": batch_size,
        "device": card["name"], "power_limit_w": card["power_limit_w"],
        "idle_share": dt["idle_share"], "peak_gib": peak_gib,
        "n_buildings": n_buildings, "launches": streamed["launches"]}


def run(cfg, model, scene, stream_scenes, device="cuda",
        batch_sizes=BATCH_SIZES):
    """The default run: (the JSON line as a dict, :func:`stream`'s
    output). ``scene`` is the held-out building of steps 1-2 and the
    warm-ups, ``stream_scenes`` the streamed ones."""
    from detection_3d_tpu_torch.utils.device import card_info, resolve_device
    dev = resolve_device(device)
    card = card_info(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    dt = device_time(cfg, model, scene, dev)
    streamed = stream(cfg, model, stream_scenes, scene, dev, batch_sizes)
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    return bench_line(dt, streamed, card, peak, len(stream_scenes)), streamed


def small_line(cfg, model, scene, device="cuda"):
    """The ``--small`` run: the JSON line of bench.py:302-308 (value =
    device_s) with the card's name and power limit, the idle share and
    the host pack time beside it."""
    from detection_3d_tpu_torch.utils.device import card_info, resolve_device
    dev = resolve_device(device)
    card = card_info(dev)
    dt = device_time(cfg, model, scene, dev)
    dt_s = dt["device_s"]
    return {"metric": "inference_sec_per_building", "value": dt_s,
            "unit": "s",
            "vs_baseline": None if dt_s is None else BASELINE_S / dt_s,
            "device": card["name"], "power_limit_w": card["power_limit_w"],
            "idle_share": dt["idle_share"],
            "host_pack_pyramid_s": dt["host_pack_pyramid_s"]}


def parity(cfg, scene, device="cuda", scales=3):
    """The kernels against their plain versions on ``device`` at the
    ``scales`` largest scales of ``scene`` (module docstring); prints a
    line per check and returns the names of the failed ones.

    Kernel A is held within 1e-2 of the plain output's largest magnitude
    (at least 1): both round an f32 sum to bf16 once, in another order,
    so an output of magnitude m may differ by one bf16 step, m / 128."""
    from detection_3d_tpu_torch.data.packing import (
        batch_to_device, pad_scene)
    from detection_3d_tpu_torch.models.detector import voxelize_points
    from detection_3d_tpu_torch.ops.sparse import (
        conv_rulebook, downsample_table, downsample_with_rulebooks,
        neighbor_indices, neighbor_match_3x3x3, submanifold_offsets)
    from detection_3d_tpu_torch.ops.sparse_conv import (
        Book, deconv_rulebook, gather_conv, masks_row_order, sparse_conv)
    from detection_3d_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    s3d = cfg.sparse3d
    offs = submanifold_offsets((3, 3, 3))
    failures = []

    def hold(ok, name, line):
        print(f"parity {line}: {'OK' if ok else 'MISMATCH'}")
        if not ok:
            failures.append(name)

    with torch.inference_mode():
        (pts, fts, valid), _, _ = batch_to_device(pad_scene(cfg, scene), dev)
        t = voxelize_points(cfg, pts, fts, valid)
        caps = cfg.caps.scale_caps(s3d.num_scales, base=t.capacity)
        for s in range(min(scales, s3d.num_scales - 1)):
            want = neighbor_indices(t, offs)
            got, masks = neighbor_match_3x3x3(t)
            hold(torch.equal(want, got), f"subm_match_s{s}",
                 f"scale {s} subm match {tuple(want.shape)}")
            cin = cout = 32
            rng = np.random.RandomState(s)
            rv = t.row_valid
            feats = (torch.from_numpy(rng.randn(t.capacity, cin).astype(
                np.float32)).to(dev) * rv[:, None]).to(torch.bfloat16)
            w = torch.from_numpy((rng.randn(27, cin, cout) * 0.1).astype(
                np.float32)).to(dev).to(torch.bfloat16)
            ref = gather_conv(feats, want, w, rv).float()
            out = sparse_conv(feats, Book(got, masks_row_order(masks)), w,
                              rv).float()
            err = float((out - ref).abs().max())
            tol = 1e-2 * max(1.0, float(ref.abs().max()))
            hold(err <= tol, f"gather_conv_s{s}",
                 f"scale {s} gather conv bf16 {cin}->{cout} max_err="
                 f"{err:.3e} (tolerance {tol:.3e})")
            kernel, stride = s3d.kernels[s], s3d.strides[s]
            nxt = downsample_table(t, kernel, stride, caps[s + 1])
            nxt2, crb, drb = downsample_with_rulebooks(t, kernel, stride,
                                                       caps[s + 1])
            hold(torch.equal(conv_rulebook(nxt, t, kernel, stride), crb)
                 and torch.equal(nxt.coords, nxt2.coords), f"conv_rb_s{s}",
                 f"scale {s}->{s + 1} conv rulebook (scatter)")
            hold(torch.equal(deconv_rulebook(t, nxt, kernel, stride), drb),
                 f"deconv_rb_s{s}",
                 f"scale {s + 1}->{s} deconv rulebook (scatter)")
            t = nxt
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--small", action="store_true",
                       help="small_config() on a 100k-point building")
    which.add_argument("--parity", action="store_true",
                       help="the kernels against their plain versions")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--buildings", type=int, default=N_STREAM,
                    help="distinct buildings streamed")
    args = ap.parse_args(argv)
    from detection_3d_tpu_torch.config.defaults import (
        full_scale_config, small_config)
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from detection_3d_tpu_torch.utils.device import card_info, resolve_device
    dev = resolve_device(args.device)
    card = card_info(dev)
    print(f"card: {card['line']}", file=sys.stderr)
    cfg = small_config() if args.small else full_scale_config()
    scene = building(cfg, 0, args.small)
    if args.parity:
        failures = parity(cfg, scene, dev)
        print(json.dumps({"parity": "FAIL", "failures": failures}
                         if failures else {"parity": "OK"}))
        return 1 if failures else 0
    model = SparseRCNN(cfg, seed=0)
    if args.small:
        line = small_line(cfg, model, scene, dev)
    else:
        print(f"generating {args.buildings} distinct buildings...",
              file=sys.stderr)
        scenes = [building(cfg, STREAM_SEED + i)
                  for i in range(args.buildings)]
        line, _ = run(cfg, model, scene, scenes, dev)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
