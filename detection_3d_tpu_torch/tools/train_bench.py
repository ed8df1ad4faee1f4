"""Training-step benchmark on the card: s/step, device busy time and the
kernels that take it.

    python -m detection_3d_tpu_torch.tools.train_bench [--config gen|full]
        [--iters 5] [--top 10] [--device cuda|cpu]

Counterpart of the repo-level tools/train_bench.py. One building, one
Trainer on the card (forward, backward with kernels A', the gated SGD
update), at:

  gen   tools/generalization_check.gen_config() on a 35k-point
        synthetic_varied_building (25 vox/m, 5 scales);
  full  full_scale_config() on the bench's 500k-point multiroom building
        (50 vox/m, a 4096 x 4096 x 512 grid, 9 scales).

Reports the first step's time, loss and voxel count; s/step over
``--iters`` steps by the host clock to the synchronised losses; the
device's busy time per step and its idle share over ``--iters`` more
steps under torch.profiler (utils/profiling.device_activity); and the
``--top`` activities by device time per step, the port's kernels under
their own names (A, dFeats, dW, B, C, D). Prints the card's name and
power limit first. Runs on the card; ``--device cpu`` runs on the CPU
with the plain kernels, the device fields then "not measured". Without
a card the default raises.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import torch


def bench_setup(name: str):
    """(config, building) of ``--config`` ``name`` ("gen" or "full")."""
    if name == "gen":
        from detection_3d_tpu_torch.data.synthetic import (
            synthetic_varied_building)
        from detection_3d_tpu_torch.tools.generalization_check import (
            gen_config)
        cfg = gen_config()
        return cfg, synthetic_varied_building(
            seed=0, num_points=35_000, classes=cfg.classes,
            voxel_scale=cfg.sparse3d.voxel_scale)
    if name == "full":
        from detection_3d_tpu_torch.config.defaults import full_scale_config
        from detection_3d_tpu_torch.tools.bench import building
        cfg = full_scale_config()
        return cfg, building(cfg, 0)
    raise ValueError(f"config {name!r}: expected 'gen' or 'full'")


def run(cfg, scene, device="cuda", iters=5, top=10, seed=0):
    """The benchmark on one building: a Trainer on ``device`` from
    SparseRCNN(cfg, seed), its samplers drawing from one generator
    seeded with ``seed``; 1 + 2 * ``iters`` steps. Returns {first_step_s,
    first_loss, first_ok, voxels, s_per_step, losses (the total of the
    first 1 + ``iters`` steps), device_s_per_step, idle_share,
    top_ms_per_step ([label, ms] by device time per step)}; the device
    fields None on the CPU."""
    from detection_3d_tpu_torch.data.packing import pad_scene
    from detection_3d_tpu_torch.engine.trainer import Trainer
    from detection_3d_tpu_torch.utils.device import resolve_device
    from detection_3d_tpu_torch.utils.profiling import device_activity
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(cfg, output_dir=out_dir, device=dev)
        state = trainer.init_state(seed=seed, iters_per_epoch=1)
        batch = pad_scene(cfg, scene)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def step():
            return trainer.step(state, batch, gen)

        t0 = time.perf_counter()
        total, _, ok, voxels = step()       # the losses fetched: synchronised
        first_s = time.perf_counter() - t0
        totals = [total]
        t0 = time.perf_counter()
        for _ in range(iters):
            totals.append(step()[0])
        s_per_step = (time.perf_counter() - t0) / iters
        act = device_activity(lambda: [step() for _ in range(iters)], dev,
                              top=top)
    busy = act["busy_ms"]
    return {"first_step_s": first_s, "first_loss": totals[0],
            "first_ok": ok, "voxels": voxels, "s_per_step": s_per_step,
            "iters": iters, "losses": totals,
            "device_s_per_step": None if busy is None else
            busy / iters / 1e3,
            "idle_share": act["idle_share"],
            "top_ms_per_step": None if act["top_ms"] is None else
            [[label, ms / iters] for label, ms in act["top_ms"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="gen", choices=["gen", "full"])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from detection_3d_tpu_torch.utils.device import card_info, resolve_device
    dev = resolve_device(args.device)
    print(f"card: {card_info(dev)['line']}")
    cfg, scene = bench_setup(args.config)
    r = run(cfg, scene, dev, args.iters, args.top)
    print(f"first step: {r['first_step_s']:.3f}s loss={r['first_loss']:.4f} "
          f"ok={r['first_ok']} voxels={r['voxels']}")
    print(f"train step ({args.config}): {r['s_per_step']:.4f} s/step over "
          f"{args.iters} steps (host clock, synchronised)")
    if r["device_s_per_step"] is None:
        print("device busy time and idle share: not measured (CPU)")
        return 0
    print(f"device busy: {r['device_s_per_step']:.4f} s/step, idle share "
          f"{r['idle_share']:.3f} over {args.iters} more steps")
    print("top device time per step (port kernels: A, dFeats, dW, B, C, D):")
    for label, ms in r["top_ms_per_step"]:
        print(f"  {ms:9.3f} ms/step  {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
