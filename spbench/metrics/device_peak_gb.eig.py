"""device_peak_gb.eig: the most device memory the allocator held during
the window (GB): the contour plan picks batched, per-node or streaming by
bytes."""


def read(run):
    if run.window_peak_bytes is None or run.window_peak_bytes <= 0:
        return None
    return run.window_peak_bytes / 1e9
