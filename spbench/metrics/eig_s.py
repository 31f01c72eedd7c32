"""eig_s: time per FEAST window to all its pairs at the configuration's
tolerance, back to back (s): the window's time up to the end of its last
request, over the number of requests."""

from spbench.readers import time_per_request


def read(run):
    return time_per_request(run)
