"""analyze_s.request: the port's multifrontal ``analyze`` of each
request's new pattern, with no grid dims and no ordering (s), host clock
around the call and a synchronise, mean over the requests."""

from spbench.readers import mean


def read(run):
    return mean(run.span_values("analyze"))
