"""analyze.order_s: the ordering stage of the port's ``analyze`` of each
request's pattern (s), as the symbolic's own record holds it
(``MFSymbolic.stats["order_s"]``, host clock), mean over the requests;
nothing where the port keeps no record."""

from spbench.readers import mean


def read(run):
    return mean(run.counter_values("analyze.order_s"))
