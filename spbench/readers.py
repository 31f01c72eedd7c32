"""What the metric readers share: a run's time per request, its tail, and
the mean of a span or a counter."""

from __future__ import annotations

import statistics


def time_per_request(run):
    """The window's time up to the end of the last request that started in
    it, over the number of those requests (untraced runs: the whole
    window)."""
    reqs = run.requests
    if not reqs:
        return None
    return (reqs[-1].end - run.window_start) / len(reqs)


def p95(run):
    """95th percentile of the requests' own times, hand-off to answer."""
    times = [r.end - r.start for r in run.requests]
    if len(times) < 20:
        return None
    return statistics.quantiles(times, n=20, method="inclusive")[-1]


def mean(values):
    return sum(values) / len(values) if values else None


def idle_pct(run):
    """Per cent of the traced window in which nothing ran on the device."""
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def kernel_roofline(run, fragment: str, indexed: bool):
    """Per cent of the HBM roofline that the kernel named ``fragment``
    reaches on the run's operator, from its mean device time a launch."""
    from spbench.roofline import roofline_pct, spmv_bytes

    if run.trace is None:
        return None
    secs, launches = run.trace.kernel(fragment)
    if not launches:
        return None
    info = run.info
    nbytes = spmv_bytes(info["n"], info["n"], info["nnz"], info["itemsize"],
                        indexed)
    return roofline_pct(nbytes, secs / launches)
