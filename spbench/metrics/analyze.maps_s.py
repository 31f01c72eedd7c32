"""analyze.maps_s: the maps stage of the port's ``analyze`` of each
request's pattern (s: the frontal locate structure, the A-entry, extend-add
and solve maps), as the symbolic's own record holds it
(``MFSymbolic.stats["maps_s"]``, host clock), mean over the requests;
nothing where the port keeps no record."""

from spbench.readers import mean


def read(run):
    return mean(run.counter_values("analyze.maps_s"))
