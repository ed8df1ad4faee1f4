"""Per-stage inference timing on the card: nested prefixes of the forward.

    python -m detection_3d_tpu_torch.tools.profile_inference [--small]
        [--device cuda|cpu] [--iters 3]

Counterpart of the repo-level tools/profile_inference.py. Times the
nested prefixes of one building's forward at full_scale_config() on the
bench's 500k-point building (``--small``: small_config() on its 100k-point
one), with seeded random weights:

  voxelize   the input layer (voxelize_points);
  +pyramid   and build_pyramid (tables, rulebooks, kernel B);
  +backbone  and the SparseFPN (kernel A);
  +rpn       and the RPN (kernel C in its NMS);
  full       the whole forward (ROI head and post-processing).

Each prefix takes one warm-up call, then ``--iters`` rounds call every
prefix once in turn, each call timed by the host clock and ending
synchronised, with Python's garbage collector paused (as timeit does);
a prefix's time is its median over the rounds, and a stage's cost the
median over the rounds of the difference between its prefix and the
one before. (The JAX tool averages ``iters`` calls of one prefix after
another and subtracts the averages; on a shared host a slow spell then
falls on one prefix, and a stage of a few ms, such as the RPN's, can
come out negative.) Beside each prefix: the device's busy time and idle
share over one more call (utils/profiling.device_activity). Prints the
card's name and power limit first. Runs on the card; ``--device cpu``
runs on the CPU with the plain kernels, the device fields then "not
measured". Without a card the default raises.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time

import numpy as np
import torch

STAGES = ("voxelize", "+pyramid", "+backbone", "+rpn", "full")


def stage_fns(cfg, model):
    """{prefix: fn(points, feats, points_valid)} over tensors on the
    model's device, each returning the prefix's outputs: voxelize (the
    features' sum, num), +pyramid (every table's num), +backbone (the sum
    of the RPN maps' features, f32), +rpn (the sum of the first group's
    proposal boxes) and full (the packed (K, 10) detections and
    true_num, as make_predict_fn gives them)."""
    from detection_3d_tpu_torch.engine.trainer import pack_detections
    from detection_3d_tpu_torch.models.backbone import build_pyramid
    from detection_3d_tpu_torch.models.detector import voxelize_points
    dtype = getattr(torch, cfg.compute_dtype)

    def table(pts, fts, valid):
        t = voxelize_points(cfg, pts, fts, valid)
        return t.with_feats(t.feats.to(dtype))

    def maps(pts, fts, valid):
        t = table(pts, fts, valid)
        return model.backbone(t, build_pyramid(t, cfg))

    def voxelize(pts, fts, valid):
        t = voxelize_points(cfg, pts, fts, valid)
        return t.feats.sum(), t.num

    def pyramid(pts, fts, valid):
        pyr = build_pyramid(table(pts, fts, valid), cfg)
        return torch.stack([x.num for x in pyr["tables"]])

    def backbone(pts, fts, valid):
        rpn_maps, _ = maps(pts, fts, valid)
        return sum(m.feats.float().sum() for m in rpn_maps)

    def rpn(pts, fts, valid):
        rpn_maps, _ = maps(pts, fts, valid)
        proposals, _ = model.rpn(rpn_maps, None, None)
        return proposals[0].boxes.sum()

    def full(pts, fts, valid):
        t = voxelize_points(cfg, pts, fts, valid)
        return pack_detections(model(t)), t.true_num

    return dict(zip(STAGES, (voxelize, pyramid, backbone, rpn, full)))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def profile(cfg, model, scene, device="cuda", iters=3):
    """Time every prefix of :func:`stage_fns` on ``scene`` (module
    docstring): a list of {stage, s (the median seconds of a call),
    stage_s (the median difference to the prefix before), busy_ms,
    idle_share}
    in prefix order, and {stage: outputs of its last call}. ``model`` is
    moved to ``device`` and set to eval."""
    from detection_3d_tpu_torch.engine.trainer import batch_to_device, pad_scene
    from detection_3d_tpu_torch.utils.device import resolve_device
    from detection_3d_tpu_torch.utils.profiling import device_activity
    dev = resolve_device(device)
    model = model.to(dev).eval()
    (pts, fts, valid), _, _ = batch_to_device(pad_scene(cfg, scene), dev)
    fns = stage_fns(cfg, model)
    secs = {name: [] for name in fns}
    outs, rows = {}, []
    with torch.inference_mode():
        for fn in fns.values():
            fn(pts, fts, valid)
        collecting = gc.isenabled()
        gc.disable()
        try:
            for _ in range(iters):
                for name, fn in fns.items():
                    _sync(dev)
                    t0 = time.perf_counter()
                    outs[name] = fn(pts, fts, valid)
                    _sync(dev)
                    secs[name].append(time.perf_counter() - t0)
        finally:
            if collecting:
                gc.enable()
        prev = None
        for name, fn in fns.items():
            t = np.asarray(secs[name])
            act = device_activity(lambda: fn(pts, fts, valid), dev)
            rows.append({"stage": name, "s": float(np.median(t)),
                         "stage_s": float(np.median(
                             t if prev is None else t - prev)),
                         "busy_ms": act["busy_ms"],
                         "idle_share": act["idle_share"]})
            prev = t
    return rows, outs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="small_config() on a 100k-point building")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args(argv)
    from detection_3d_tpu_torch.config.defaults import (
        full_scale_config, small_config)
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from detection_3d_tpu_torch.tools.bench import building
    from detection_3d_tpu_torch.utils.device import card_info, resolve_device
    dev = resolve_device(args.device)
    print(f"card: {card_info(dev)['line']}")
    cfg = small_config() if args.small else full_scale_config()
    scene = building(cfg, 0, args.small)
    rows, _ = profile(cfg, SparseRCNN(cfg, seed=0), scene, dev, args.iters)
    for r in rows:
        busy = ("not measured" if r["busy_ms"] is None else
                f"busy {r['busy_ms']:.3f} ms, idle {r['idle_share']:.3f}")
        print(f"{r['stage'] + ':':10s} {r['s']:.4f}s (stage "
              f"{r['stage_s']:+.4f}s; device {busy})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
