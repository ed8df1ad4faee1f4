"""The traced sub-window: torch.profiler over a few seconds inside a
run's window, from a synchronised start to a synchronised end, and what
the per-layer readers take from it.

Busy time is the union of the device activities over every stream, so a
copy beside a kernel counts once; the idle share divides by the
sub-window's own host-clock length, so idle time at its edges counts.
Kernels are told apart by the benchmark's own copy of the port's kernel
symbols (:data:`SYMBOLS`), and by the program's spans that were open on
the thread that launched them (:func:`span_kernel_seconds`), so that a
kernel's device time can be read whatever implements it."""

from __future__ import annotations

import re
import time
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

# a kernel's symbols in a device trace: kernel A's body runs under the
# ConvForward and ConvDFeats tags, dW is a partial kernel and its
# reduction, D one of three forms, E a pack and a walk, BN the masked
# batch norm's three forward and three backward kernels, ROI the rotated
# pooler's forward and its backward's two (matched in this order: no
# later symbol occurs in an earlier kernel's name)
SYMBOLS = {"A": "ConvForward", "dFeats": "ConvDFeats", "dW": "gather_dw_",
           "B": "subm_match_", "C": "rotated_iou_kernel",
           "D": "multi_match_", "E": "greedy_nms_", "BN": "masked_bn_",
           "ROI": "roi_align_rotated_"}
MARK = "perfbench.subwindow"
# a call of the CUDA API on the host: cudaLaunchKernel,
# cudaGraphLaunch, cuLaunchKernel, ...
_RUNTIME = re.compile(r"cu(da)?[A-Z]")


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


class Record(NamedTuple):
    """One activity of a trace, times in microseconds: a span (a
    ``record_function`` range; ``correlation`` None), a launch (a CUDA
    API call on the host, such as ``cudaLaunchKernel`` or
    ``cudaGraphLaunch``), a device activity (``thread`` its stream) or
    an autograd operation of the backward (``forward`` the thread whose
    forward it differentiates). A device activity has the correlation id
    of the launch that put it on the device."""
    name: str
    thread: int
    start: float
    end: float
    correlation: Optional[int] = None
    forward: Optional[int] = None


def _sweep(evs):
    """Walks one thread's (time, kind, x) events, kind 0 an opening, 1 a
    query, 2 a closing of x, in time order (at one time an opening
    before a query, a query before a closing: the ends hold their
    queries); yields (query x, the names open at it)."""
    evs.sort(key=lambda e: (e[0], e[1]))
    depth = Counter()
    for _, kind, x in evs:
        if kind == 0:
            depth[x] += 1
        elif kind == 2:
            depth[x] -= 1
            if depth[x] <= 0:
                del depth[x]
        else:
            yield x, tuple(depth)


def span_kernel_seconds(spans: Iterable[Record], launches: Iterable[Record],
                        kernels: Iterable[Record],
                        ops: Iterable[Record] = ()) -> Dict[str, float]:
    """{span name: device seconds of the kernels launched while a span of
    that name was open on the launching thread}. A launch made inside
    an autograd operation of the backward (``ops``, run on the autograd
    engine's own thread) counts also for the spans open at that moment
    on the thread whose forward the operation differentiates, which
    waits in ``backward()`` meanwhile. A kernel is tied to its launch by
    the correlation id, and counts once for each name open there, so a
    span's kernels include those of the spans inside it. Copies and
    fills count for no span, nor does a kernel whose launch is not among
    ``launches`` or ran with no span open."""
    launches = list(launches)
    events = defaultdict(list)
    for o in ops:
        if o.forward is not None and o.forward != o.thread:
            events[o.thread] += [(o.start, 0, o.forward),
                                 (o.end, 2, o.forward)]
    for launch in launches:
        events[launch.thread].append((launch.start, 1, launch))
    # the forward threads a launch inside a backward operation serves
    served = defaultdict(list)
    for evs in events.values():
        for launch, forwards in _sweep(evs):
            for f in forwards:
                served[f].append(launch)
    events = defaultdict(list)
    for s in spans:
        events[s.thread] += [(s.start, 0, s.name), (s.end, 2, s.name)]
    for launch in launches:
        events[launch.thread].append((launch.start, 1, launch.correlation))
    for f, ls in served.items():
        events[f] += [(launch.start, 1, launch.correlation) for launch in ls]
    open_at = defaultdict(set)
    for evs in events.values():
        for corr, names in _sweep(evs):
            open_at[corr].update(names)
    out: Dict[str, float] = {}
    for k in kernels:
        if _is_copy(k.name):
            continue
        for name in open_at.get(k.correlation, ()):
            out[name] = out.get(name, 0.0) + (k.end - k.start) / 1e6
    return out


def records(events):
    """(spans, launches, kernels, ops) of a profiler's events as
    :class:`Record` s: the host's ``record_function`` ranges but the
    sub-window's own, its CUDA API calls, the device's activities, and
    the autograd operations run for another thread's forward (the
    profiler's forward thread id). A launch takes the thread of the host
    operations made on its system thread (torch numbers threads its own
    way); a launch from a thread whose operations the profiler did not
    record is left out."""
    spans, launches, kernels, ops, cpu, tid_of = [], [], [], [], [], {}
    for e in events:
        kind = getattr(e, "device_type", None)
        if kind == DeviceType.CPU:
            cpu.append(e)
        elif kind == DeviceType.CUDA and not getattr(e, "is_user_annotation",
                                                     False):
            kernels.append(Record(e.name, getattr(e, "device_resource_id", 0),
                                  e.time_range.start, e.time_range.end, e.id))
    for e in cpu:
        if not _RUNTIME.match(e.name):
            tid_of.setdefault(getattr(e, "device_resource_id", None),
                              e.thread)
    for e in cpu:
        if getattr(e, "is_user_annotation", False):
            if e.name != MARK:
                spans.append(Record(e.name, e.thread, e.time_range.start,
                                    e.time_range.end))
        elif _RUNTIME.match(e.name):
            sys_tid = getattr(e, "device_resource_id", None)
            thread = tid_of.get(sys_tid) if sys_tid is not None else e.thread
            if thread is not None:
                launches.append(Record(e.name, thread, e.time_range.start,
                                       e.time_range.end, e.id))
        elif getattr(e, "fwd_thread", None) and e.fwd_thread != e.thread:
            ops.append(Record(e.name, e.thread, e.time_range.start,
                              e.time_range.end, forward=e.fwd_thread))
    return spans, launches, kernels, ops


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
          kernel_n       {letter: activities} of each, to count against
                         its launches (the profiler may lose some);
          span_kernel_s  {span name: seconds} of the kernels launched in
                         the program's spans (:func:`span_kernel_seconds`);
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
        n_label: Dict[str, int] = {}
        for name, s, e in dev:
            k = label(name)
            by_label[k] = by_label.get(k, 0.0) + (e - s) / 1e6
            n_label[k] = n_label.get(k, 0) + 1
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
                "kernel_n": {k: n_label.get(k, 0) for k in SYMBOLS},
                "span_kernel_s": span_kernel_seconds(*records(events)),
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
