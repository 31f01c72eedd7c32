"""The device trace of a ``--trace 1`` run, reduced in memory.

``torch.profiler`` records the host's operators and the card's kernels,
copies and sets (CUPTI) over whole requests; no trace file is written.
The reduction keeps:

* ``busy_s``: the union of the device's intervals (kernels, copies, sets;
  not the mirrors of host spans that the profiler draws on the device's
  timeline);
* ``window_s``: the traced window on the host clock, synchronised at both
  ends;
* ``kernels``: device seconds and launches by name;
* ``device_ops``: the ten names with the most device time;
* ``idle_gaps``: the gaps between the device's busy intervals, summed by
  what the host was doing at their midpoint (the outermost ``spbench.*``
  span, the innermost ``aten::`` operator and the innermost event open
  then), the ten largest.
"""

from __future__ import annotations

import time
from collections import defaultdict

TOP = 10


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    return name.replace("(anonymous namespace)::", "").split("(", 1)[0][:160]


class Trace:
    def __init__(self, window_s: float, device_events, host_events):
        self.window_s = window_s
        self.kernels = defaultdict(lambda: [0.0, 0])
        for name, start, dur in device_events:
            row = self.kernels[name]
            row[0] += dur * 1e-9
            row[1] += 1
        merged = []
        for start, end in sorted((s, s + d) for _, s, d in device_events):
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        self.device_ops = [[_short(n), row[0]] for n, row in top]
        gaps = [(merged[k][1], merged[k + 1][0])
                for k in range(len(merged) - 1)]
        self.idle_gaps = _name_gaps(gaps, host_events)

    def kernel(self, fragment: str):
        """(device seconds, launches) of the kernels whose name holds
        ``fragment``."""
        secs = sum(r[0] for n, r in self.kernels.items() if fragment in n)
        count = sum(r[1] for n, r in self.kernels.items() if fragment in n)
        return secs, count


def _name_gaps(gaps, host_events) -> list:
    """Sum the gaps by what the host was doing at each gap's midpoint;
    host events of one thread nest, so a stack of open events sweeps
    them in order of their starts."""
    host = sorted(host_events, key=lambda e: (e[1], -e[2]))
    sums = defaultdict(float)
    stack, j = [], 0
    for start, end in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (start + end) // 2
        while j < len(host) and host[j][1] <= mid:
            while stack and stack[-1][2] <= host[j][1]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][2] <= mid:
            stack.pop()
        span = next((e[0] for e in stack if e[0].startswith("spbench.")),
                    "outside spbench spans")
        inner = stack[-1][0] if stack else "no host op"
        op = next((e[0] for e in reversed(stack)
                   if e[0].startswith("aten::")), inner)
        name = f"{span} / {inner}" if op == inner else \
            f"{span} / {op} / {inner}"
        sums[name] += (end - start) * 1e-9
    return [[k, v] for k, v in sorted(sums.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


class Profiler:
    """``torch.profiler`` over the host and, on a CUDA device, the card."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = torch.profiler.profile(activities=acts, acc_events=True)
        self.t0 = None

    def start(self) -> None:
        from spbench.harness import sync

        sync(self.device)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> Trace:
        import torch

        from spbench.harness import sync

        sync(self.device)
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        device_events, host_events = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == cuda:
                # a span's mirror on the device timeline is no device work
                if not (e.is_user_annotation()
                        or e.name().startswith("spbench.")):
                    device_events.append((e.name(), start, dur))
            else:
                host_events.append((e.name(), start, start + dur))
        return Trace(window_s, device_events, host_events)
