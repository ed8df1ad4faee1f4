"""Host syncs in the program's ``train.step`` spans of the traced
sub-window over their number; it serves every metric
``syncs_per_step.<part>``."""

from perfbench.spans import syncs_per_step


def read(run):
    return syncs_per_step(run)
