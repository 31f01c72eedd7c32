"""cg.ms_per_iter: host-clock time of the port's ``cg`` calls over their
iterations (ms)."""


def read(run):
    secs = run.span_values("cg")
    its = run.counter_values("cg.iterations")
    if not secs or not sum(its) or len(secs) != len(its):
        return None
    return 1e3 * sum(secs) / sum(its)
