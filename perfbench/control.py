"""The control of the check, the faults planted to test it, and the tool
that reads the check's numbers of the program, the control and the
faults on many seeds in one process.

The control is the reference put in the program's place and computed in
the nearest precision below the configuration's bfloat16: float8 (e4m3,
one scale a tensor). Every weight matrix is rounded to it once, and the
floating inputs of every compute module (the sparse convs, the NiN
shortcuts, the down and up layers, the BEV convs, the RPN head, the ROI
feature extractor and predictor) are rounded to it on entry (gradients
pass the rounding unchanged). Its detections, or its first training
steps, go through the same comparison with the float32 reference as the
program's, and have to fail it.

    python3 -m perfbench.control --workload <cell> --seeds S [S ...] \
        [--control-seeds S [S ...]]

prints one JSON line a seed: the worst numbers of the program's answers
(its window run briefly, at the cell's own load and sizes) and, for the
control seeds, of the control's; for a training cell also of the
program with each planted fault of :data:`FAULTS`.

    python3 -m perfbench.control --workload <train cell> --look S [S ...]

is the look behind the training check's choice of numbers (PERF.md):
for each seed, the spread of the leaves' gaps of the program as the
configuration states it, of the same program computed in float32, and
of the control, with the worst leaves by name; and the ROI head's
sampled positives of each program against the reference's.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
from torch import nn

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale that maps its largest
    magnitude to the format's largest, and back to its dtype; the
    gradient passes the rounding unchanged, in ``x``'s dtype."""
    with torch.no_grad():
        amax = x.abs().max()
        if not torch.isfinite(amax) or amax == 0:
            return x
        scale = amax.to(torch.float32) / FP8_MAX
        q = ((x.to(torch.float32) / scale).to(FP8).to(torch.float32)
             * scale).to(x.dtype)
    return q if not x.requires_grad else x + (q - x).detach()


def _round_args(module, args):
    def r(a):
        if torch.is_tensor(a) and a.is_floating_point():
            return fp8_round(a)
        if type(a) in (list, tuple):
            return type(a)(r(x) for x in a)
        return a
    return tuple(r(a) for a in args)


def fp8(model: nn.Module) -> nn.Module:
    """The reference ``model`` turned into the control, in place."""
    from perfbench.reference import backbone, roi_head, rpn
    kinds = (backbone.SubmConv, backbone.NiN, backbone.DownLayer,
             backbone.BEVConv, rpn.RPNHead, roi_head.ROIBoxFeatureExtractor,
             roi_head.ROIPredictor)
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2:
                p.copy_(fp8_round(p))
    for m in model.modules():
        if isinstance(m, kinds):
            m.register_forward_pre_hook(_round_args)
    return model


def half_batch(monkeypatch_target):
    """A planted fault: every balanced sample keeps its first half of
    rows only, so each loss is the mean over the rest. Returns the
    undo."""
    from detection_3d_tpu_torch.models import matcher, roi_head, rpn
    real = matcher.balanced_sample

    def halved(labels, priorities, batch_size, positive_fraction):
        pos, neg = real(labels, priorities, batch_size, positive_fraction)
        half = torch.arange(labels.shape[-1], device=labels.device) < \
            labels.shape[-1] // 2
        return pos & half, neg & half
    for mod in (rpn, roi_head):
        monkeypatch_target(mod, "balanced_sample", halved)


def altered_total(monkeypatch_target):
    """A planted fault: the step's total loss, which the step reports
    and whose gradient makes the update, comes out doubled."""
    from detection_3d_tpu_torch.engine import trainer
    real = trainer.total_loss
    monkeypatch_target(trainer, "total_loss",
                       lambda losses: 2.0 * real(losses))


def unchanged_state(monkeypatch_target):
    """A planted fault: the step leaves the parameters as they were."""
    from detection_3d_tpu_torch.engine.solver import Solver
    monkeypatch_target(Solver, "apply", lambda self, ok=None: None)


FAULTS = {"half_batch": half_batch, "altered_total": altered_total,
          "unchanged_state": unchanged_state}


class _Patches:
    """setattr with an undo, for planting a fault in one process."""

    def __init__(self):
        self.undo = []

    def __call__(self, obj, name, value):
        self.undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def restore(self):
        for obj, name, value in reversed(self.undo):
            setattr(obj, name, value)
        self.undo = []


def _train_lines(cell, args, device):
    from perfbench import harness as bench, train
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from perfbench.inputs import load, meta_model
    steps = int(cell.traffic["checked_steps"])
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        run = bench.prepare(cell, seed, args.seconds, False, device)
        bench.drive(run)
        got = bench.close_window(run)
        run.draws = got["draws"]
        want = train.reference_steps(run, bench.reference_model(run), steps)
        line = {"seed": seed, "kind": run.kind}
        if seed in args.seeds:
            line["program"] = train.numbers(got, want, run.weights)
        if seed in args.control_seeds:
            ctl = train.reference_steps(run, bench.reference_model(run, fp8),
                                        steps)
            line["control"] = train.numbers(ctl, want, run.weights)
            for name, plant in FAULTS.items():
                patches = _Patches()
                plant(patches)
                try:
                    run.model = load(meta_model(SparseRCNN, run.cfg),
                                     run.weights, device)
                    bench.drive(run)
                    bad = bench.close_window(run)
                finally:
                    patches.restore()
                line[name] = train.numbers(bad, want, run.weights)
        print(json.dumps(line), flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()


def _leaf_summary(got, want, start):
    """The check's numbers and the spread of the leaves' change gaps."""
    import numpy as np
    from perfbench import train
    out = train.numbers(got, want, start)
    g, c = train.leaf_gaps(got, want, start)
    q = np.quantile(np.asarray(list(c.values())), [0.5, 0.75, 0.95])
    out["change_q50_q75_q95"] = [float(x) for x in q]
    out["worst_change"] = sorted(([n, c[n]] for n in c),
                                 key=lambda kv: -kv[1])[:6]
    out["worst_grad"] = sorted(([n, g[n]] for n in g),
                               key=lambda kv: -kv[1])[:6]
    return out


class _Positives:
    """Records the ROI head's sampled positives (their proposals' boxes)
    of every ``subsample_proposals`` call of a detector module."""

    def __init__(self, module, patches):
        self.calls = []
        real = module.subsample_proposals

        def recorded(*a, **k):
            out = real(*a, **k)
            pos = (out.valid & (out.fields["labels"] > 0)).reshape(-1)
            self.calls.append(out.boxes.reshape(-1, 7)[pos].float().cpu())
            return out
        patches(module, "subsample_proposals", recorded)


def _shared(got, want, tol: float = 0.01):
    """[program's positives, reference's, positives within ``tol`` of one
    of the other side's] of each call the reference made."""
    out = []
    for a, b in zip(got, want):
        hit = 0
        if len(a) and len(b):
            hit = int(((a[:, None, :] - b[None, :, :]).abs().amax(-1)
                       <= tol).any(1).sum())
        out.append([len(a), len(b), hit])
    return out


def _look_lines(cell, seeds, seconds, device):
    from detection_3d_tpu_torch.config.defaults import Config
    from detection_3d_tpu_torch.models import detector
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from perfbench import harness as bench, spec, train
    from perfbench.inputs import load, meta_model
    from perfbench.reference import detector as ref_detector
    steps = int(cell.traffic["checked_steps"])
    for seed in seeds:
        run = bench.prepare(cell, seed, seconds, False, device)
        line = {"seed": seed, "kind": None}
        patches = _Patches()
        try:
            mine = _Positives(detector, patches)
            bench.drive(run)
            got = bench.close_window(run)
            line["kind"] = run.kind
            run.draws = got["draws"]
            ref_pos = _Positives(ref_detector, patches)
            want = train.reference_steps(run, bench.reference_model(run),
                                         steps)
            line["program"] = _leaf_summary(got, want, run.weights)
            line["roi_positives"] = _shared(mine.calls, ref_pos.calls)
            patches.restore()
            mine = _Positives(detector, patches)
            run.cfg = spec.build_config(Config, cell.config,
                                        {"compute_dtype": "float32"})
            run.model = load(meta_model(SparseRCNN, run.cfg), run.weights,
                             device)
            bench.drive(run)
            got32 = bench.close_window(run)
            line["program_float32"] = _leaf_summary(got32, want,
                                                    run.weights)
            line["roi_positives_float32"] = _shared(mine.calls,
                                                    ref_pos.calls)
        finally:
            patches.restore()
        ctl = train.reference_steps(run, bench.reference_model(run, fp8),
                                    steps)
        line["control"] = _leaf_summary(ctl, want, run.weights)
        print(json.dumps(line), flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None, root=None, require_card: bool = True) -> int:
    """The tool's entry; ``root`` and ``require_card=False`` let the tests
    run it on a tiny benchmark on the CPU."""
    from perfbench import compare, harness as bench, spec
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=0.1)
    p.add_argument("--look", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload, root or spec.ROOT)
    device = bench.card(cell, require_card)
    if args.look:
        _look_lines(cell, args.look, args.seconds, device)
        return 0
    if cell.traffic["window"] == "train":
        _train_lines(cell, args, device)
        return 0
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        run = bench.prepare(cell, seed, args.seconds, False, device)
        bench.drive(run)
        answers = bench.close_window(run)
        line = {"seed": seed, "kind": run.kind}
        ref = bench.reference_model(run)
        if seed in args.seeds:
            line["program"] = compare.worst(bench.check(run, answers, ref))
        if seed in args.control_seeds:
            ctl = bench.reference_model(run, fp8)
            picked = [(b, bench.reference_detections(
                run.ref_cfg, ctl, bench.pad_scene(run.ref_cfg,
                                                     run.pool[b]), device))
                      for b, _ in bench.sample_answers(
                          answers, int(cell.traffic["check_answers"]), seed)]
            line["control"] = compare.worst(bench.check(run, picked, ref))
            del ctl
        print(json.dumps(line), flush=True)
        del ref, run
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
