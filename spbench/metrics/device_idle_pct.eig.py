"""device_idle_pct.eig: share of the traced window of FEAST windows in
which no kernel, copy or set ran on the device (%)."""

from spbench.readers import idle_pct


def read(run):
    return idle_pct(run)
