"""solve_s: time per CG solve to the configuration's accuracy, back to
back (s): the window's time up to the end of its last request, over the
number of requests."""

from spbench.readers import time_per_request


def read(run):
    return time_per_request(run)
