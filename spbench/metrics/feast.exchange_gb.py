"""feast.exchange_gb: GB copied between cards a window
(``pipeline.last_run["exchange_bytes"]``: the node values and right-hand
sides sent to the contour shards, the quadrature sums psum'd back), mean
over the windows."""

from spbench.readers import mean


def read(run):
    return mean(run.counter_values("feast.exchange_gb"))
