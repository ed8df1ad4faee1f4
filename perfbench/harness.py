"""One run of a cell, from set-up to the result object (run.py prints
it). Set-up (imports, the CUDA context, the port's kernel libraries from
its build directory in the checkout, the pool of buildings, the weights,
the warm-up of the cell's own shapes) is timed from the start of the
process to the start of the window. The window is the traffic mix's
(windows/<window>.py, named by the traffic mix). With ``--trace 1`` a sub-window of a few seconds
inside it is profiled and the cell's per-layer metrics are read from it
(metrics/); otherwise its end-to-end metrics are reported. Once the
window has closed and the peak memory is read, the program is freed and
its answers are held against the plain reference (reference/, float32,
TF32 off) under the cell's limits (limits/<cell>.json). The model, its
reference, its weights' scales, the comparison of its answers and the
count of its work come from the family that the cell's configuration
names (families/<family>.py).
"""

from __future__ import annotations

import gc
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench import compare, counts, guard, spec, train
from perfbench.inputs import load, make_weights
from perfbench.serve import sample_answers
from perfbench.traffic.pool import PendingPool

_T_IMPORT = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def _stamp(what: str):
    """Prints the process's age at a step of the set-up (stderr)."""
    print(f"set-up: {what} done at {_process_age():.2f} s", file=sys.stderr)


class Run:
    """One run of a cell: what its window, its check and the per-layer
    readers share."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: torch.device):
        self.cell, self.seed, self.seconds, self.trace = (cell, seed, seconds,
                                                          trace)
        self.traffic = cell.traffic
        self.device = device
        self.setup_s: Optional[float] = None
        self.window: Dict = {}
        self.sub: Optional[Dict] = None
        self.work: Optional[List[Dict]] = None   # per pool building
        self.peaks = None

    @property
    def esize(self) -> int:
        """Bytes of a feature in the configured compute dtype."""
        return getattr(torch, self.cfg.compute_dtype).itemsize

    def window_starts(self):
        self.setup_s = _process_age()


def card(cell, require_card: bool = True) -> torch.device:
    """The card a run uses; without ``require_card`` the CPU (tests).
    Raises SystemExit when the cell's cards are not there."""
    if not require_card:
        return torch.device("cpu")
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        raise SystemExit(f"perfbench: the cell needs {cell.chips} CUDA "
                         f"card(s); found {found}")
    return torch.device("cuda", 0)


def prepare(cell, seed: int, seconds: float, trace: bool,
            device: torch.device, pool: PendingPool = None) -> Run:
    """Set-up before the window: the cell's family, the two
    configurations, the kernels, the pool of buildings (``pool``, when
    its generation was started before this process loaded torch), the
    weights and the program's model."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, seed, seconds, trace, device)
    run.family = fam = cell.family()
    run.cfg = fam.program_config(cell.config)
    run.ref_cfg = fam.reference_config(cell.config)
    if device.type == "cuda":
        from detection_3d_tpu_torch.ops import cuda_lib
        _stamp("imports")
        cuda_lib.build()
        _stamp("kernel libraries")
        torch.zeros((), device=device)
        _stamp("CUDA context")
    if pool is None:
        pool = PendingPool(seed, cell.traffic["buildings"],
                           cell.config["model"]["classes"],
                           workers=0 if device.type == "cuda" else 1)
    meta = fam.program_model(run.cfg)
    run.weights = make_weights({k: tuple(v.shape) for k, v in
                                meta.state_dict().items()}, seed, device,
                               fam.init_std)
    run.model = load(meta, run.weights, device)
    _stamp("weights and the program's model")
    run.pool = pool.get()
    _stamp(f"{len(run.pool)} buildings")
    # the reference's copy waits on the host, out of the program's peak
    run.weights = {k: v.cpu() for k, v in run.weights.items()}
    return run


def drive(run: Run) -> Dict:
    """The cell's window (``windows/<window>.py`` of its traffic mix) run
    on ``run``; returns what it recorded, kept as ``run.window``."""
    run.window = spec.window(run.cell.root, run.traffic["window"])(run)
    return run.window


def close_window(run: Run):
    """After the window: the peak memory and the card's name, the traced
    sub-window's summary, and the program's model freed. Returns the
    window's answers."""
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
        run.memory_peak = int(torch.cuda.max_memory_allocated(run.device))
        run.kind = torch.cuda.get_device_name(run.device)
    else:
        run.memory_peak, run.kind = 0, "cpu"
    sub = run.window.pop("sub")
    run.sub = sub.summary() if sub is not None else None
    answers = run.window.pop("answers")
    run.model = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    return answers


def reference_model(run: Run, control=None):
    """The reference's own model on the run's weights, in float32;
    ``control`` (the family's) makes it the control."""
    ref = load(run.family.reference_model(run.ref_cfg), run.weights,
               run.device)
    return control(ref) if control is not None else ref


def trained(answers) -> bool:
    """Whether a window's answers are a training window's record of its
    first steps (a dict), and not served answers, a list of (pool
    building, answer)."""
    return isinstance(answers, dict)


def check(run: Run, answers, ref) -> List[Dict[str, float]]:
    """The numbers of each checked answer against the reference ``ref``,
    as the family gives them: a training window's first steps against
    the family's ``reference_steps`` (train.numbers), or each sampled
    served answer (the family's ``serving_numbers``); prints one line
    each."""
    fam = run.family
    if trained(answers):
        run.draws = answers["draws"]
        want = fam.reference_steps(run, ref, len(answers["totals"]))
        out = [train.numbers(answers, want, run.weights)]
        print("compared steps: " + ", ".join(
            f"{k} {v!r}" for k, v in out[0].items()), file=sys.stderr)
        return out
    picked = sample_answers(answers, int(run.traffic["check_answers"]),
                            run.seed)
    out = []
    for b, got in picked:
        out.append(fam.serving_numbers(run, got, ref, b))
        print(f"compared building {b}: " + ", ".join(
            f"{k} {v!r}" for k, v in out[-1].items()), file=sys.stderr)
    return out


def run_cell(args, require_card: bool = True, root: Path = spec.ROOT,
             pool: PendingPool = None) -> Dict:
    """One run; returns the result object. ``require_card=False`` runs on
    the CPU (the tests)."""
    cell = spec.load_cell(args.workload, root)
    device = card(cell, require_card)
    run = prepare(cell, args.seed, float(args.seconds), bool(args.trace),
                  device, pool)
    drive(run)
    answers = close_window(run)
    limits = cell.limits()
    per_building = check(run, answers, reference_model(run))
    correct, rows = compare.judge(compare.worst(per_building), limits)
    attempted = len(run.window["buildings"])
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": sum(1 for pb in per_building
                            if not compare.judge(pb, limits)[0])}
    if args.trace:
        run.peaks = counts.peaks(run.kind)
        fam = run.family
        run.work = [fam.building_work(
            run.ref_cfg, fam.reference_pad(run.ref_cfg, b), device,
            train=trained(answers)) for b in run.pool]
        if run.sub is not None:
            for what, key in (("kernels recorded", "kernel_n"),
                              ("kernel seconds", "kernel_s"),
                              ("kernel seconds by span", "span_kernel_s")):
                print(f"{what}: " + ", ".join(
                    f"{k} {v!r}" for k, v in sorted(run.sub[key].items())),
                    file=sys.stderr)
        metrics = {}
        for m in cell.per_layer:
            v = spec.metric_reader(cell.root, m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        values = dict(run.window["e2e"], setup_s=run.setup_s)
        result["metrics"] = {m["name"]: {"value": float(values[m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = {"platform": "gpu" if device.type == "cuda"
                        else "cpu", "kind": run.kind, "count": cell.chips,
                        "memory_peak_bytes": run.memory_peak}
    if args.trace and run.sub is not None:
        result["device"]["busy_s"] = run.sub["busy_s"]
        result["device"]["window_s"] = run.sub["window_s"]
        result["breakdown"] = {"device_ops": run.sub["device_ops"],
                               "idle_gaps": run.sub["idle_gaps"]}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, v, lim in rows}
    found = guard.forbidden_modules()
    if found:
        raise SystemExit("perfbench: JAX or the JAX package was loaded: "
                         + ", ".join(found))
    for k, v, lim in rows:
        print(f"compared {k}: {v!r} limit {lim!r}", file=sys.stderr)
    return result
