"""analyze_s.eig: the FEAST pipeline's ``analyze`` of the union pattern in
the cold window of set-up (s), as ``pipeline.last_run["analyze_s"]``
records it."""

from spbench.readers import mean


def read(run):
    return mean(run.span_values("feast.analyze"))
