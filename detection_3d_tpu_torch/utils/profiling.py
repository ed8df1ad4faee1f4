"""Tracing and profiling hooks over torch.profiler.

Counterpart of detection_3d_tpu/utils/profiling.py (the reference has
per-iteration timing and max-memory logging only, trainer_sparse3d.py:
74,119-143): a profiler trace of a block, named regions that show in it,
a step timer that waits for the device, and the device's memory
statistics.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


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
