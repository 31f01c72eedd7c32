"""cg.iterations: CG iterations a solve (``CgResult.iterations``), mean."""

from spbench.readers import mean


def read(run):
    return mean(run.counter_values("cg.iterations"))
