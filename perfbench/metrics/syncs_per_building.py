"""Host syncs in the program's ``model.predict`` spans of the traced
sub-window (torch's sync detector, counted by the program to the span
open where each was made) over the buildings those spans served; it
serves every metric ``syncs_per_building.<part>``."""

from perfbench.spans import syncs_per_building


def read(run):
    return syncs_per_building(run)
