"""The device's idle share of the traced sub-window, %; it serves every
metric ``idle_share.<part>``."""

from perfbench.layer import idle_share


def read(run):
    return idle_share(run)
