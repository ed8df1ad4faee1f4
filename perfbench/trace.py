"""The traced sub-window: torch.profiler over a few seconds inside a
run's window, from a synchronised start to a synchronised end, and what
the per-layer readers take from it.

Busy time is the union of the device activities over every stream, so a
copy beside a kernel counts once; the idle share divides by the
sub-window's own host-clock length, so idle time at its edges counts.
Kernels are told apart by the benchmark's own copy of the port's kernel
symbols (:data:`SYMBOLS`)."""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

# a kernel's symbols in a device trace: kernel A's body runs under the
# ConvForward and ConvDFeats tags, dW is a partial kernel and its
# reduction, D one of three forms, E a pack and a walk
SYMBOLS = {"A": "ConvForward", "dFeats": "ConvDFeats", "dW": "gather_dw_",
           "B": "subm_match_", "C": "rotated_iou_kernel",
           "D": "multi_match_", "E": "greedy_nms_"}
MARK = "perfbench.subwindow"


def label(name: str) -> str:
    """The short name of a device activity: a hand-written kernel's
    letter, else its own name cut to 80 characters."""
    for short, sym in SYMBOLS.items():
        if sym in name:
            return short
    return name[:80]


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or low.startswith("memset")


class SubWindow:
    """Profiles host and device from :meth:`start` to :meth:`stop`; each
    waits for the device first, so every device activity of the work in
    between is inside, and none of the work before."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.seconds = None
        self.units = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.start()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, units: int):
        """Ends the sub-window after ``units`` units of work (buildings
        or steps)."""
        self._sync()
        self.seconds = time.perf_counter() - self.t0
        self._mark.__exit__(None, None, None)
        self.prof.stop()
        self.units = units

    def summary(self, top: int = 10) -> Optional[Dict]:
        """What the sub-window recorded, or None when it never ran or
        recorded no device activity (a run on the CPU):

          window_s, busy_s, units;
          launches       kernels run on the device (copies and fills
                         apart);
          kernel_s       {letter: seconds} of each hand-written kernel;
          device_ops     the ``top`` activities by summed time,
                         [[label, seconds], ...];
          idle_gaps      the ``top`` longest stretches with nothing on
                         the device, each named by what the host did at
                         its middle (:func:`_host_at`), [[name, seconds]].
        """
        if self.prof is None or self.seconds is None:
            return None
        events = self.prof.events()
        # the device's own activities: a named host range shows on the
        # device's timeline too, as an annotation
        dev = [(e.name, e.time_range.start, e.time_range.end)
               for e in events
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != MARK]
        if not dev:
            return None
        marks = [e for e in events if e.name == MARK]
        w0 = marks[0].time_range.start if marks else min(s for _, s, _ in dev)
        w1 = marks[0].time_range.end if marks else max(e for _, _, e in dev)
        main = marks[0].thread if marks else None
        busy = _merge([(s, e) for _, s, e in dev])
        by_label: Dict[str, float] = {}
        for name, s, e in dev:
            k = label(name)
            by_label[k] = by_label.get(k, 0.0) + (e - s) / 1e6
        host = [e for e in events
                if getattr(e, "device_type", None) == DeviceType.CPU
                and e.name != MARK]
        mine = [e for e in host if main is None or e.thread == main]
        gaps = _gaps(busy, w0, w1)
        gaps.sort(key=lambda g: g[0] - g[1])
        named = [[_host_at(mine, host, (a + b) / 2), (b - a) / 1e6]
                 for a, b in gaps[:top]]
        return {"window_s": self.seconds,
                "busy_s": sum(e - s for s, e in busy) / 1e6,
                "units": self.units,
                "launches": sum(1 for n, _, _ in dev if not _is_copy(n)),
                "kernel_s": {k: by_label.get(k, 0.0) for k in SYMBOLS},
                "device_ops": sorted(([k, v] for k, v in by_label.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": named}


def _merge(intervals) -> List[tuple]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _gaps(busy, w0, w1) -> List[tuple]:
    out, at = [], w0
    for s, e in busy:
        if s > at:
            out.append((at, min(s, w1)))
        at = max(at, e)
    if at < w1:
        out.append((at, w1))
    return [(a, b) for a, b in out if b > a]


def _innermost(events, t):
    best = None
    for e in events:
        if e.time_range.start <= t <= e.time_range.end:
            if best is None or (e.time_range.end - e.time_range.start
                                < best.time_range.end
                                - best.time_range.start):
                best = e
    return best


def _host_at(mine, host, t) -> str:
    """What the host did at host time ``t``: the innermost torch
    operation then on the thread that opened the sub-window, else on any
    other thread, else the last one that thread ended before ``t`` (the
    host was then in code torch does not record: Python, a native
    library, a wait)."""
    e = _innermost(mine, t)
    if e is not None:
        return e.name[:80]
    e = _innermost(host, t)
    if e is not None:
        return ("other thread: " + e.name)[:80]
    done = [x for x in mine if x.time_range.end <= t]
    if done:
        return ("after " + max(done, key=lambda x: x.time_range.end).name
                )[:80]
    return "(no host operation)"
