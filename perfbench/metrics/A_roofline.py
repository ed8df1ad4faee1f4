"""Kernel A's least time for the traced sub-window's buildings (the
larger of operations over the peak rate and bytes over the memory
bandwidth, counts.py) over its device time there, %."""

from perfbench.layer import roofline_a


def read(run):
    return roofline_a(run)
