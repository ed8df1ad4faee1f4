"""Tracing and profiling hooks over torch.profiler.

Counterpart of detection_3d_tpu/utils/profiling.py (the reference has
per-iteration timing and max-memory logging only, trainer_sparse3d.py:
74,119-143): a profiler trace of a block, named regions that show in it,
a step timer that waits for the device, the device's memory
statistics, and :func:`device_activity`: the device's busy time, idle
share and time by kernel over one call, from a profiler trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from detection_3d_tpu_torch.ops.cuda_lib import LABELS, SYMBOLS
from detection_3d_tpu_torch.utils.device import resolve_device


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (host and, with a card, device
    activity) and write its Chrome trace to ``log_dir``/trace.json;
    yields the profiler, whose ``key_averages()`` sums by kernel."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def named_scope(name: str):
    """A region named ``name`` in the profiler's trace
    (torch.profiler.record_function)."""
    return record_function(name)


class StepTimer:
    """Host clock of a step that ends when the device has finished: stop
    synchronises the card of every CUDA tensor it is given."""

    def __init__(self):
        self.t0: Optional[float] = None

    def start(self):
        self.t0 = time.perf_counter()

    def stop(self, *tensors) -> float:
        for dev in {t.device for t in tensors if t.is_cuda}:
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - self.t0
        self.t0 = None
        return dt


def device_memory_stats(device="cuda") -> Dict[str, Dict]:
    """{device name: torch.cuda.memory_stats} for every card (the
    reference logs torch.cuda.max_memory_allocated,
    trainer_sparse3d.py:141). Raises without a card unless asked for the
    CPU (``device="cpu"``), which has none: ``{}``."""
    if torch.device(device).type == "cpu":
        return {}
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_stats: CUDA is not available "
                           "(pass device='cpu' for the host)")
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}


def interval_union(intervals) -> float:
    """The length that (start, end) intervals cover, each overlap once."""
    total, lo, hi = 0.0, None, None
    for start, end in sorted(intervals):
        if hi is None or start > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return total if hi is None else total + hi - lo


def kernel_label(name: str) -> str:
    """The port's short name of a device activity (A, dFeats, dW, B, C,
    D: ops/cuda_lib.LABELS), else its own name cut to 90 characters."""
    for counter, sym in SYMBOLS.items():
        if sym in name:
            return LABELS[counter]
    return name[:90]


def activity_summary(events, top: int = 15) -> Dict:
    """Device time of ``events``, (name, start_us, end_us, stream) of
    every device activity (kernels, copies, fills) on any stream, in ms:

      busy_ms      the union of their time ranges: when two streams run
                   at once (a copy beside a kernel) the overlap counts
                   once;
      sum_ms       the sum of their durations, overlaps counted twice
                   (the reading before the union, kept to compare);
      span_ms      from the first start to the last end;
      idle_share   1 - busy_ms / span_ms;
      memcpy_ms    the summed durations of the copies;
      streams      how many streams the activities ran on;
      port_kernels_ms  the time of each port kernel, by launch counter
                   (ops/cuda_lib.SYMBOLS);
      by_name_ms   the summed time of each activity name;
      top_ms       the ``top`` largest [label, ms], port kernels under
                   their short names (:func:`kernel_label`).
    """
    if not events:
        raise ValueError("activity_summary: no device activity")
    by_name, by_label = {}, {}
    for name, start, end, _ in events:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e3
    for name, ms in by_name.items():
        label = kernel_label(name)
        by_label[label] = by_label.get(label, 0.0) + ms
    busy = interval_union((s, e) for _, s, e, _ in events) / 1e3
    span = (max(e for _, _, e, _ in events)
            - min(s for _, s, _, _ in events)) / 1e3
    return {"busy_ms": busy, "sum_ms": sum(by_name.values()),
            "span_ms": span,
            "idle_share": 1.0 - busy / span if span > 0 else None,
            "memcpy_ms": sum(v for n, v in by_name.items()
                             if "memcpy" in n.lower()),
            "device_activities": len(events),
            "streams": len({st for _, _, _, st in events}),
            "port_kernels_ms": {
                k: sum(v for n, v in by_name.items() if sym in n)
                for k, sym in SYMBOLS.items()},
            "by_name_ms": by_name,
            "top_ms": sorted(([k, v] for k, v in by_label.items()),
                             key=lambda kv: -kv[1])[:top]}


def device_activity(fn, device="cuda", top: int = 15) -> Dict:
    """Run ``fn()`` once under torch.profiler (host and device activity)
    and return :func:`activity_summary` of every device activity it
    caused, beside ``device``, the card's name.

    On the card (the default) it raises without CUDA
    (utils/device.resolve_device), and raises when the profiler records
    no device activity: the caller gets a device reading or an error,
    never a host clock in its place. On the CPU (``device="cpu"``) it
    runs ``fn`` and every device field reads None (not measured)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        fn()
        return {"device": "cpu", "busy_ms": None, "sum_ms": None,
                "span_ms": None, "idle_share": None, "memcpy_ms": None,
                "device_activities": 0, "streams": 0,
                "port_kernels_ms": None, "by_name_ms": None, "top_ms": None}
    from torch.autograd import DeviceType
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    events = [(e.name, e.time_range.start, e.time_range.end,
               getattr(e, "device_resource_id", 0))
              for e in prof.events()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not events:
        raise RuntimeError("device_activity: the profiler recorded no "
                           "device activity on the card")
    return {"device": torch.cuda.get_device_name(dev),
            **activity_summary(events, top)}
