"""feast.loops: FEAST refinement loops a window, mean over the windows
(``pipeline.last_run["loops"]``)."""

from spbench.readers import mean


def read(run):
    return mean(run.counter_values("feast.loops"))
