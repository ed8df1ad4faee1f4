"""Host seconds in the program's ``model.plan`` spans (a segmentation
forward's tables and books, models/minkunet.MinkUNet34C.plan) over the
traced sub-window's length, %; it serves every metric
``plan_share.<part>``. None where the program logged no such span."""

from perfbench.spans import named


def read(run):
    found = named(run, "model.plan")
    if found is None or run.sub["window_s"] <= 0:
        return None
    return 100.0 * sum(r.seconds for r in found) / run.sub["window_s"]
