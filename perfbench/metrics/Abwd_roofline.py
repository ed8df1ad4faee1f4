"""Kernel A''s least time (dFeats and dW) for the traced sub-window's
steps (counts.py) over its device time there, %."""

from perfbench.layer import roofline_a_backward


def read(run):
    return roofline_a_backward(run)
