"""What the span readers (metrics/syncs_per_building.py,
syncs_per_step.py, pad_share.py, dispatch_share.py) take from a traced
run: the program's own span log of the sub-window
(``detection_3d_tpu_torch.utils.profiling.recorded_spans``: each whole
span's name, start and end on the host clock, parent, buildings and host
syncs). The log is read once a run and kept on it. Each reader returns
None when the run recorded no sub-window, when the program keeps no such
log, or when no span of the name it reads was logged."""

from __future__ import annotations


def spans(run):
    """The span records of the run's traced sub-window, or None."""
    if run.sub is None:
        return None
    if not hasattr(run, "spans"):
        try:
            from detection_3d_tpu_torch.utils.profiling import recorded_spans
        except ImportError:     # a program without spans
            run.spans = None
        else:
            run.spans = recorded_spans()
    return run.spans


def named(run, name: str):
    """The logged spans called ``name``, or None when there are none."""
    log = spans(run)
    found = [r for r in log or () if r.name == name]
    return found or None


def syncs_per_building(run):
    """Host syncs in the ``model.predict`` spans (those of the spans
    inside them included) over the buildings they served."""
    found = named(run, "model.predict")
    if found is None:
        return None
    return sum(r.syncs_within for r in found) / sum(r.buildings
                                                    for r in found)


def syncs_per_step(run):
    """Host syncs in the ``train.step`` spans over their number."""
    found = named(run, "train.step")
    if found is None:
        return None
    return sum(r.syncs_within for r in found) / len(found)


def pad_share(run):
    """Seconds in ``data.pad_scene`` over the sub-window's, %."""
    found = named(run, "data.pad_scene")
    if found is None or run.sub["window_s"] <= 0:
        return None
    return 100.0 * sum(r.seconds for r in found) / run.sub["window_s"]


def dispatch_share(run):
    """Seconds in ``serve.dispatch`` over those of the ``serve.unit``
    spans holding them, over the units logged whole, %."""
    units = {r.id: r for r in named(run, "serve.unit") or ()}
    inside = [r for r in named(run, "serve.dispatch") or ()
              if r.parent in units]
    if not inside:
        return None
    held = sum(units[r.parent].seconds for r in inside)
    return 100.0 * sum(r.seconds for r in inside) / held
