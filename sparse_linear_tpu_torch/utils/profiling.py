"""Profiling / tracing hooks.

Counterpart of :mod:`sparse_linear_tpu.utils.profiling`, with the same
three names, over ``torch.profiler`` in place of ``jax.profiler``:

* :func:`trace` — context manager around ``torch.profiler.profile``: CPU
  activity, and the card's kernels when CUDA is initialised, written as
  one Chrome / Perfetto trace file into ``log_dir`` (TensorBoard's
  ``*.pt.trace.json`` naming).
* :func:`annotate` — a named span: ``torch.profiler.record_function``
  while a profiler runs, nothing otherwise.  The profiler's own state is
  the switch: with none running a span costs one check of it.  Under
  ``torch.autograd.profiler.emit_nvtx()`` every span is an NVTX range, so
  it shows in Nsight too.
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


_OFF = contextlib.nullcontext()


def annotate(name: str, args=None):
    """Named span for trace viewers: ``with annotate("slt.mf.factor.level",
    lvl): ...``.  ``name`` is a constant; what varies goes in ``args`` (a
    value, or a tuple of values joined by spaces), formatted only while a
    profiler runs.  With none running (``torch.autograd._profiler_enabled``
    false) the span is a shared no-op context: no ``record_function``, no
    string formatting."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if args is not None:
        args = (" ".join(map(str, args)) if isinstance(args, tuple)
                else str(args))
    return torch.profiler.record_function(name, args)


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
