"""assembly_ms: the port's ``from_triples`` and CSR of one request's
triples (ms), host clock around the calls and a synchronise, mean."""

from spbench.readers import mean


def read(run):
    m = mean(run.span_values("assembly"))
    return None if m is None else 1e3 * m
