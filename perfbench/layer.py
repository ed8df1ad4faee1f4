"""What several per-layer readers (metrics/) compute alike from a traced
run: the device's idle share of the sub-window, kernel launches per unit
of work, a kernel's share of its roofline (by its symbols, or by the
program's spans that launched it) and the whole forward's share of the
card's peak. Each returns None when the run recorded nothing to
read (no trace, no device activity, or a card without a row in the
table of peaks)."""

from __future__ import annotations

from perfbench import counts


def idle_share(run):
    s = run.sub
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def launches_per_unit(run):
    s = run.sub
    if s is None or not s["units"]:
        return None
    return s["launches"] / s["units"]


def roofline_a(run):
    """Kernel A's least time for the sub-window's buildings over its
    device time there, in %."""
    s = run.sub
    if s is None or run.peaks is None or not s["kernel_s"]["A"]:
        return None
    dtype = run.cfg.compute_dtype
    least = sum(counts.least_seconds(run.work[b]["a_convs"], run.esize,
                                     run.peaks, dtype)
                for b in run.window["sub_buildings"])
    return 100.0 * least / s["kernel_s"]["A"]


def roofline_a_backward(run):
    """Kernel A' (dFeats and dW): the least time of the backward of the
    sub-window's steps' convs over their device time there, in %."""
    s = run.sub
    if s is None or run.peaks is None:
        return None
    busy = s["kernel_s"]["dFeats"] + s["kernel_s"]["dW"]
    if not busy:
        return None
    least = sum(counts.backward_least_seconds(
        run.work[b]["a_convs"], run.esize, run.peaks, run.cfg.compute_dtype)
        for b in run.window["sub_buildings"])
    return 100.0 * least / busy


def roofline_by_span(run, spans, least_seconds):
    """``least_seconds`` (a family's least time for the sub-window's work)
    over the device seconds of the kernels launched in the program's
    spans named ``spans`` (trace.span_kernel_seconds; spans that do not
    open inside one another), in %; None where those spans launched
    nothing or the run recorded no sub-window."""
    s = run.sub
    if s is None or least_seconds is None:
        return None
    busy = sum(s["span_kernel_s"].get(name, 0.0) for name in spans)
    if not busy:
        return None
    return 100.0 * least_seconds / busy


def mfu(run):
    """The window's model operations (a training step's forward and
    backward) over its wall time and the card's peak rate in the
    configured compute dtype, in %."""
    if run.peaks is None or run.work is None:
        return None
    flops = sum(run.work[b]["flops"] for b in run.window["buildings"])
    peak = run.peaks[run.cfg.compute_dtype]
    return 100.0 * flops / (run.window["window_s"] * peak)
