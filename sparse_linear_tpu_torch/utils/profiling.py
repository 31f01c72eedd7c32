"""Profiling / tracing hooks.

Counterpart of :mod:`sparse_linear_tpu.utils.profiling`, with the same
three names, over ``torch.profiler`` in place of ``jax.profiler``:

* :func:`trace` — context manager around ``torch.profiler.profile``: CPU
  activity, and the card's kernels when CUDA is initialised, written as
  one Chrome / Perfetto trace file into ``log_dir`` (TensorBoard's
  ``*.pt.trace.json`` naming).
* :func:`annotate` — a named span: ``torch.profiler.record_function``,
  plus an NVTX range when CUDA is initialised, so the span shows in
  Nsight too.
* :func:`op_timings` — wall-clock timing of a callable, first call and
  steady state apart, synchronised on the card.
"""

from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["trace", "annotate", "op_timings"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the enclosed block into ``log_dir``
    (view with TensorBoard or Perfetto).  Yields the
    ``torch.profiler.profile`` object, whose ``key_averages()`` sum the
    recorded events by name once the block has ended."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities, acc_events=True,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    with prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str):
    """Named span for trace viewers: ``with annotate("factor:level3"): ...``"""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_initialized():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _wait() -> None:
    """Wait for the card's queued work (the port runs on one card)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def op_timings(fn, *args, iters: int = 20):
    """Measure (first_call_seconds, steady_seconds_per_call) of a callable,
    each timed up to the end of the work queued on the card.  On the card
    the first call includes building the kernel library with nvcc (once
    per process) and creating cuBLAS / cuSOLVER handles, where the JAX
    package's includes an XLA compile."""
    t0 = time.perf_counter()
    fn(*args)
    _wait()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _wait()
    steady_s = (time.perf_counter() - t0) / iters
    return first_s, steady_s
