"""device_peak_gb.cards: the most device memory any card's allocator held
during the window (GB), read per window from ``pipeline.last_run["cards"]``
after every card's peak was reset at the end of set-up."""


def read(run):
    values = run.counter_values("device_peak_gb.cards")
    if not values or max(values) <= 0:
        return None
    return max(values)
