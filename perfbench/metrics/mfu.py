"""The model operations of the window's buildings (a serving window's
forwards) or steps (a training window's forwards and backwards,
counts.py) over the window's wall time and the card's peak rate, %; it
serves every metric ``mfu.<part>``."""

from perfbench.layer import mfu


def read(run):
    return mfu(run)
