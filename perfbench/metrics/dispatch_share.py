"""Host seconds in the serving loop's ``serve.dispatch`` spans over
those of the ``serve.unit`` spans that hold them, over the units of the
traced sub-window logged whole, %; it serves every metric
``dispatch_share.<part>``."""

from perfbench.spans import dispatch_share


def read(run):
    return dispatch_share(run)
