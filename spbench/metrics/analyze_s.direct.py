"""analyze_s.direct: the port's multifrontal ``analyze`` of the pattern in
set-up (s), host clock around the call."""

from spbench.readers import mean


def read(run):
    return mean(run.span_values("analyze"))
