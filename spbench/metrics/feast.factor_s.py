"""feast.factor_s: seconds of a window's factorizations of the shifted
contour matrices (``pipeline.last_run``), mean over the windows."""

from spbench.readers import mean


def read(run):
    return mean(run.counter_values("feast.factor_s"))
