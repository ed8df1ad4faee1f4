"""The control of the check, the faults planted to test it, and the tool
that reads the check's numbers of the program, the control and the
faults on many seeds in one process.

The control is the reference put in the program's place and computed in
the nearest precision below the configuration's bfloat16: float8 (e4m3,
one scale a tensor). Every weight matrix is rounded to it once, and the
floating inputs of every compute module (the family's ``control`` names
their kinds; for the detector: the sparse convs, the NiN shortcuts, the
down and up layers, the BEV convs, the RPN head, the ROI feature
extractor and predictor) are rounded to it on entry (gradients pass the
rounding unchanged). Its answers, or its first training steps, go
through the same comparison with the float32 reference as the program's,
and have to fail it.

    python3 -m perfbench.control --workload <cell> --seeds S [S ...] \
        [--control-seeds S [S ...]]

prints one JSON line a seed: the worst numbers of the program's answers
(its window run briefly, at the cell's own load and sizes) and, for the
control seeds, of the control's; for a training cell also of the
program with each planted fault of the family's ``FAULTS``.

    python3 -m perfbench.control --workload <train cell> --look S [S ...]

is the look behind the training check's choice of numbers (PERF.md),
the family's ``look``: for the detector, for each seed, the spread of
the leaves' gaps of the program as the configuration states it, of the
same program computed in float32, and of the control, with the worst
leaves by name; and the ROI head's sampled positives of each program
against the reference's.
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


def fp8(model: nn.Module, kinds) -> nn.Module:
    """The reference ``model`` turned into the control, in place: every
    weight matrix rounded to float8 once, and the floating inputs of each
    module of ``kinds`` (a family's compute modules, its ``control``)
    rounded on entry."""
    with torch.no_grad():
        for p in model.parameters():
            if p.ndim >= 2:
                p.copy_(fp8_round(p))
    for m in model.modules():
        if isinstance(m, kinds):
            m.register_forward_pre_hook(_round_args)
    return model


class Patches:
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


def _train_line(run, got, line, seeds, control_seeds):
    """A training cell's line: the program's numbers and, on a control
    seed, the control's and each planted fault's (the family's
    ``FAULTS``)."""
    from perfbench import harness as bench, train
    from perfbench.inputs import load
    fam = run.family
    steps = int(run.traffic["checked_steps"])
    run.draws = got["draws"]
    want = fam.reference_steps(run, bench.reference_model(run), steps)
    if run.seed in seeds:
        line["program"] = train.numbers(got, want, run.weights)
    if run.seed not in control_seeds:
        return
    ctl = fam.reference_steps(run, bench.reference_model(run, fam.control),
                              steps)
    line["control"] = train.numbers(ctl, want, run.weights)
    for name, plant in fam.FAULTS.items():
        patches = Patches()
        plant(patches)
        try:
            run.model = load(fam.program_model(run.cfg), run.weights,
                             run.device)
            bench.drive(run)
            bad = bench.close_window(run)
        finally:
            patches.restore()
        line[name] = train.numbers(bad, want, run.weights)


def _serve_line(run, answers, line, seeds, control_seeds):
    """A serving cell's line: the worst numbers of the program's sampled
    answers and, on a control seed, of the control's answers to the
    same buildings."""
    from perfbench import compare, harness as bench
    fam = run.family
    ref = bench.reference_model(run)
    if run.seed in seeds:
        line["program"] = compare.worst(bench.check(run, answers, ref))
    if run.seed in control_seeds:
        ctl = bench.reference_model(run, fam.control)
        picked = [(b, fam.reference_answer(run, ctl, b))
                  for b, _ in bench.sample_answers(
                      answers, int(run.traffic["check_answers"]), run.seed)]
        line["control"] = compare.worst(bench.check(run, picked, ref))


def leaf_summary(got, want, start):
    """The training check's numbers and the spread of the leaves' change
    gaps, with the worst leaves by name."""
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


def main(argv=None, root=None, require_card: bool = True) -> int:
    """The tool's entry; ``root`` and ``require_card=False`` let the tests
    run it on a tiny benchmark on the CPU."""
    from perfbench import harness as bench, spec
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
        cell.family().look(cell, args.look, args.seconds, device)
        return 0
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        run = bench.prepare(cell, seed, args.seconds, False, device)
        bench.drive(run)
        answers = bench.close_window(run)
        line = {"seed": seed, "kind": run.kind}
        if bench.trained(answers):
            _train_line(run, answers, line, args.seeds, args.control_seeds)
        else:
            _serve_line(run, answers, line, args.seeds, args.control_seeds)
        print(json.dumps(line), flush=True)
        del run
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
