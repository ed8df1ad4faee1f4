"""The rotated ROI pooler's least time for the traced sub-window's
buildings over its device time there (every kernel labelled ROI), %:
the least time of each pooler call the family counts (``roi_pools`` of
its building_work, a served forward's) is its bytes (counts.roi_bytes:
the pooled output written, the merged table's features and keys and the
rois read once) over the memory bandwidth. None where the family counts
no calls (a training step's work counts none: its backward's sort runs
between the ROI kernels) or ROI ran for no time. It serves every metric
``ROI_roofline.<part>``."""

from perfbench.counts import roi_bytes


def read(run):
    s = run.sub
    if s is None or run.peaks is None or not s["kernel_s"].get("ROI"):
        return None
    pools = [p for b in run.window["sub_buildings"]
             for p in run.work[b].get("roi_pools", ())]
    if not pools:
        return None
    least = roi_bytes(pools, run.esize) / run.peaks["hbm"]
    return 100.0 * least / s["kernel_s"]["ROI"]
