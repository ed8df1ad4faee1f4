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
TF32 off) under the cell's limits (limits/<cell>.json).
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
from perfbench.inputs import load, make_weights, meta_model
from perfbench.reference.train import pad_scene
from perfbench.serve import reference_detections, sample_answers
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
    """Set-up before the window: the two configurations, the kernels,
    the pool of buildings (``pool``, when its generation was started
    before this process loaded torch), the weights and the program's
    model."""
    from detection_3d_tpu_torch.config.defaults import Config
    from detection_3d_tpu_torch.models.detector import SparseRCNN
    from perfbench.reference.config import Config as RefConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = Run(cell, seed, seconds, trace, device)
    run.cfg = spec.build_config(Config, cell.config)
    run.ref_cfg = spec.build_config(RefConfig, cell.config,
                                    {"compute_dtype": "float32"})
    if device.type == "cuda":
        from detection_3d_tpu_torch.ops import cuda_lib
        _stamp("imports")
        cuda_lib.build()
        _stamp("kernel libraries")
        torch.zeros((), device=device)
        _stamp("CUDA context")
    if pool is None:
        pool = PendingPool(seed, cell.traffic["buildings"], run.cfg.classes,
                           workers=0 if device.type == "cuda" else 1)
    meta = meta_model(SparseRCNN, run.cfg)
    run.weights = make_weights({k: tuple(v.shape) for k, v in
                                meta.state_dict().items()}, seed, device)
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
    ``control`` (control.fp8) makes it the control."""
    from perfbench.reference.detector import SparseRCNN as RefRCNN
    ref = load(meta_model(RefRCNN, run.ref_cfg), run.weights, run.device)
    return control(ref) if control is not None else ref


def check(run: Run, answers, ref) -> List[Dict[str, float]]:
    """The numbers of each checked answer against the reference ``ref``:
    a training window's first steps (train.numbers), or each sampled
    served building's detections (compare.py); prints one line each."""
    if run.traffic["window"] == "train":
        run.draws = answers["draws"]
        want = train.reference_steps(run, ref, len(answers["totals"]))
        out = [train.numbers(answers, want, run.weights)]
        print("compared steps: " + ", ".join(
            f"{k} {v!r}" for k, v in out[0].items()), file=sys.stderr)
        return out
    picked = sample_answers(answers, int(run.traffic["check_answers"]),
                            run.seed)
    out = []
    for b, got in picked:
        want = reference_detections(
            run.ref_cfg, ref, pad_scene(run.ref_cfg, run.pool[b]),
            run.device)
        out.append(compare.building_numbers(got, want))
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
        run.work = [counts.building_work(
            run.ref_cfg, pad_scene(run.ref_cfg, b), device,
            train=cell.traffic["window"] == "train") for b in run.pool]
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
