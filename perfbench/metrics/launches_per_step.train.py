"""Kernels run on the device in the traced sub-window over the
training steps taken in it."""

from perfbench.layer import launches_per_unit


def read(run):
    return launches_per_unit(run)
