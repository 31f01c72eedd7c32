"""refactor_p95_s: 95th percentile of one refactor-and-solve request, from
the hand-off of its triples to the port until x is ready on the device
(s)."""

from spbench.readers import p95


def read(run):
    return p95(run)
