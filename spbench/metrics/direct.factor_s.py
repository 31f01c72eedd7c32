"""direct.factor_s: the port's Cholesky ``factor`` of one request (s),
host clock around the call and a synchronise, mean over the requests."""

from spbench.readers import mean


def read(run):
    return mean(run.span_values("factor"))
