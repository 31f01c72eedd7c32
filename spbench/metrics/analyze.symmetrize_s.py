"""analyze.symmetrize_s: the symmetrize stage of the port's ``analyze`` of
each request's pattern (s: the permuted pattern of A + Aᵀ + I that the
elimination tree and the supernodes are built on), as the symbolic's own
record holds it (``MFSymbolic.stats["symmetrize_s"]``, host clock), mean
over the requests; nothing where the port keeps no record."""

from spbench.readers import mean


def read(run):
    return mean(run.counter_values("analyze.symmetrize_s"))
