"""feast.card_factor_s: seconds of the slowest card's factorizations of
its contour nodes a window, each card's timed on its own stream
(``pipeline.last_run["cards"]``), mean over the windows."""

from spbench.readers import mean


def read(run):
    return mean(run.counter_values("feast.card_factor_s"))
