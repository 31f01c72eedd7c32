"""feast.solves_s: seconds of a window's contour solves, summed over its
loops (``pipeline.last_run``), mean over the windows."""

from spbench.readers import mean


def read(run):
    return mean(run.counter_values("feast.solves_s"))
