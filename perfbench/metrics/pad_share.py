"""Host seconds in the program's ``data.pad_scene`` spans
(``engine/trainer.pad_scene``) over the traced sub-window's length, %;
it serves every metric ``pad_share.<part>``."""

from perfbench.spans import pad_share


def read(run):
    return pad_share(run)
