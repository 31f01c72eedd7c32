"""device_idle_pct.refactor: share of the traced window of refactor-and-
solve requests in which no kernel, copy or set ran on the device (%)."""

from spbench.readers import idle_pct


def read(run):
    return idle_pct(run)
