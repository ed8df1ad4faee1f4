"""Tracing and profiling hooks over torch.profiler.

Counterpart of detection_3d_tpu/utils/profiling.py (the reference has
per-iteration timing and max-memory logging only, trainer_sparse3d.py:
74,119-143): a profiler trace of a block, the port's spans and their
host-sync counts, the device's memory statistics, and
:func:`device_activity`: the device's busy time, idle share and time by
kernel over one call, from a profiler trace.

Spans. :func:`span` names a stage of the port where its work happens
(``engine/trainer.pad_scene``, ``engine/inference``'s predict and serving
loop, ``models/detector``'s stages, ``Trainer.step``'s parts). With no
profiler running it returns one shared null context after one
process-wide check. While a profiler runs (any thread's: torch's flag is
the process's) a span is a ``record_function`` range in the profiler's
trace, on the clock of the device's activities, and a
:class:`SpanRecord` in a bounded in-memory log that
:func:`recorded_spans` returns and clears. A span is logged only when a
profiler ran both when it opened and when it closed, so the log holds
whole spans alone.

Host syncs. While a profiler runs, torch's sync detector is on
(``torch.cuda.set_sync_debug_mode("warn")``): each ``.item()``,
``.cpu()``, ``nonzero``, pageable copy or stream synchronize warns, and
every such warning (an ``always`` filter: a site that syncs twice counts
2) is counted to the innermost span open on the thread that synced and
kept off stderr. The detector's previous mode, the warning filters and
``warnings.showwarning`` come back once the profiler has stopped: at the
first span that finds no profiler running, or at
:func:`recorded_spans`. With no profiler the detector is off, so an
untraced run pays nothing for it.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import re
import threading
import time
import warnings
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile, record_function

from detection_3d_tpu_torch.ops.cuda_lib import LABELS, SYMBOLS
from detection_3d_tpu_torch.utils.device import resolve_device

# what torch's sync detector says at a host sync (c10/cuda/CUDAFunctions.h)
SYNC_MESSAGE = "called a synchronizing CUDA operation"
# spans the log keeps before it drops its oldest
SPAN_LOG_SIZE = 1 << 16


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (host and, with a card, device
    activity; the host events of every thread, the pack workers' spans
    among them) and write its Chrome trace to ``log_dir``/trace.json;
    yields the profiler, whose ``key_averages()`` sums by kernel."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    every_thread = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=acts, experimental_config=every_thread) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class SpanRecord(NamedTuple):
    """One whole span of the log.

      name          the span's name (``data.pad_scene``, ``model.rpn``, ...);
      thread        ``threading.get_ident()`` of the thread that ran it;
      start_ns, end_ns  ``time.perf_counter_ns()`` at its ends;
      id, parent    its id, and the id of the span open around it on its
                    thread (None at the top; that span may be missing
                    from the log when it was not whole);
      buildings     the buildings it served, where the caller says;
      syncs         host syncs counted to it: made on its thread while
                    it was the innermost span open there;
      syncs_within  its syncs and those of every span inside it;
      attributes    what the code inside set on the open span
                    (``with span(...) as sp: sp.attributes = {...}``; a
                    null span is None, so set them only when ``sp`` is
                    not), each tensor turned into a list or a number
                    when :func:`recorded_spans` reads the log, so setting
                    one costs no host sync; None when nothing was set.
    """
    name: str
    thread: int
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    buildings: Optional[int]
    syncs: int
    syncs_within: int
    attributes: Optional[Dict] = None

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _SyncCounter:
    """torch's sync detector and the warning hook that counts its
    reports to the innermost open span (module docstring)."""

    def __init__(self):
        self.on = False
        self._lock = threading.Lock()
        self._hook = self._show      # one bound method, compared by identity
        self._shown = None
        self._filter = None
        self._mode = None

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        if SYNC_MESSAGE in str(message):
            stack = _open_spans()
            if stack:
                stack[-1].syncs += 1
            return
        self._shown(message, category, filename, lineno, file, line)

    def start(self):
        with self._lock:
            if self.on:
                return
            self._shown = warnings.showwarning
            warnings.showwarning = self._hook
            warnings.filterwarnings("always", message=re.escape(SYNC_MESSAGE))
            self._filter = warnings.filters[0]
            if torch.cuda.is_available():
                self._mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
            self.on = True

    def stop(self):
        with self._lock:
            if not self.on:
                return
            if self._mode is not None:
                torch.cuda.set_sync_debug_mode(self._mode)
                self._mode = None
            # a warnings.catch_warnings that closed meanwhile restored both
            if warnings.showwarning is self._hook:
                warnings.showwarning = self._shown
            if self._filter in warnings.filters:
                warnings.filters.remove(self._filter)
            self._shown = self._filter = None
            self.on = False


_counter = _SyncCounter()
_log: collections.deque = collections.deque(maxlen=SPAN_LOG_SIZE)
_ids = itertools.count()
_local = threading.local()
_NULL = contextlib.nullcontext()


def _open_spans() -> list:
    """This thread's open spans, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A span while a profiler runs (:func:`span`)."""

    __slots__ = ("name", "buildings", "id", "parent", "syncs",
                 "syncs_within", "start_ns", "_range", "attributes")

    def __init__(self, name: str, buildings: Optional[int]):
        self.name, self.buildings = name, buildings
        self.attributes = None

    def __enter__(self):
        if not _counter.on:
            _counter.start()
        stack = _open_spans()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.syncs = self.syncs_within = 0
        self._range = record_function(self.name)
        self._range.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        stack = _open_spans()
        stack.pop()
        self._range.__exit__(*exc)
        self.syncs_within += self.syncs
        if stack:
            stack[-1].syncs_within += self.syncs_within
        if _autograd_profiler._is_profiler_enabled:
            _log.append(SpanRecord(
                self.name, threading.get_ident(), self.start_ns, end_ns,
                self.id, self.parent, self.buildings, self.syncs,
                self.syncs_within, self.attributes))
        return False


def span(name: str, buildings: Optional[int] = None):
    """A context naming a stage of the port ``name`` (module docstring);
    ``buildings`` says how many buildings it serves. With no profiler
    running: a shared null context, and the sync detector switched back
    off if a profiler left it on."""
    if not _autograd_profiler._is_profiler_enabled:
        if _counter.on:
            _counter.stop()
        return _NULL
    return _Span(name, buildings)


def recorded_spans() -> List[SpanRecord]:
    """The whole spans logged since the last call, by start time, and
    the log cleared; with no profiler running any more, the sync
    detector is switched off."""
    if not _autograd_profiler._is_profiler_enabled:
        _counter.stop()
    out = []
    while _log:
        r = _log.popleft()
        if r.attributes:
            r = r._replace(attributes={k: _host(v) for k, v in
                                       r.attributes.items()})
        out.append(r)
    return sorted(out, key=lambda r: r.start_ns)


def _host(value):
    """A span attribute on the host: a tensor as a number or a list, a
    list or tuple item by item."""
    if torch.is_tensor(value):
        return value.tolist()
    if isinstance(value, (list, tuple)):
        return [_host(v) for v in value]
    return value


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
