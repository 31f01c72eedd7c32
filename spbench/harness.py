"""One run of one cell: set-up, the measured window, the check, the line.

The harness knows no cell, configuration or metric by name.  It reads the
cell's entry and its metrics from ``BENCHMARK.json``, the cell's file
``spbench/workloads/<cell>.json``, the configuration's file that
``BENCHMARK.json`` names, and loads ``spbench/drivers/<driver>.py`` and
``spbench/metrics/<metric>.py`` by those names.

A driver module has five functions:

* ``setup(ctx)`` builds the cell's operator and the port's state, warms up
  every shape the window uses, and returns the driver's state;
* ``prepare(state, i)`` makes request ``i``'s inputs (the benchmark's work,
  synchronised before the request's own timer starts, inside the window);
* ``serve(state, i)`` hands request ``i`` to the port and returns when its
  answer is ready on the device, with True unless the port reported
  failure;
* ``release(state)`` frees the port's state once the window has closed;
* ``check(state)`` recomputes what the answers should be with the plain
  reference and returns ``{name: value}``; each value is held to the limit
  of the same name in the workload's ``limits``.

Which metrics a cell reports is ``BENCHMARK.json``'s to say (a metric's
``workloads``); a reader returns None where the run holds nothing for it.

On a card, set-up starts by loading the port's two native libraries (the
CUDA kernels, built by ``nvcc``, and the host library of the symbolic
analysis, built by ``g++``), each built only where the checkout does not
hold it yet: the stage ``kernel_library``, reported apart with the names of
what it built, so a checkout's first run shows what its build took.

The window starts once set-up is synchronised and keeps starting requests
until ``--seconds`` have passed; each request runs to its end.  With
``--trace 1`` the first requests, whole, covering ``trace_seconds`` of the
workload, run under ``torch.profiler`` (events kept in memory); the rest of
the window runs untraced, and host-clock metrics read those requests.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

FORBIDDEN = ("jax", "jaxlib", "flax", "sparse_linear_tpu")
CONTROL_DTYPE = {"float64": "float32"}  # the precision below the stated one


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX,
    its libraries or the JAX package, compared whole: the port's
    ``sparse_linear_tpu_torch`` is not the JAX package."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def load_file_module(path: Path, tag: str):
    """Import one file by its path (metric names hold dots and dashes)."""
    spec = importlib.util.spec_from_file_location(tag, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _cell_metrics(entries, cell: str) -> list:
    return [m for m in entries if cell in m.get("workloads", [cell])]


def load_cell(root: Path, name: str, overrides=None) -> SimpleNamespace:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its workload and
    configuration files; ``overrides`` ({"workload": {...}, "config":
    {...}}) replace keys of either, as the CPU tests do to shrink a cell."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    entry = {w["name"]: w for w in bench["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"spbench: no workload {name!r} in BENCHMARK.json")
    workload = load_json(root / "spbench" / "workloads" / f"{name}.json")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[entry["config"]]["file"])
    overrides = overrides or {}
    workload.update(overrides.get("workload", {}))
    config.update(overrides.get("config", {}))
    return SimpleNamespace(
        name=name, root=root, entry=entry, workload=workload, config=config,
        end_to_end=_cell_metrics(bench["end_to_end"], name),
        per_layer=_cell_metrics(bench["per_layer"], name))


def substream(seed: int, *keys: int) -> int:
    """A 62-bit seed for the stream ``keys`` of the run seeded ``seed``."""
    import numpy as np

    words = [int(seed) & (2 ** 64 - 1), *(int(k) & (2 ** 64 - 1)
                                         for k in keys)]
    hi, lo = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(hi) << 30) ^ int(lo)


def sampled(seed: int, i: int, rate: float) -> bool:
    """Whether request ``i`` is in the sample drawn from ``seed``."""
    return (substream(seed, i, 0x5A3) % 1_000_003) / 1_000_003 < rate


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Run:
    """What one run recorded: set-up stages, requests, spans and counters
    (each tagged traced or not), operator facts for the readers, and the
    device trace."""

    def __init__(self, device):
        self.device = device
        self.stages = {}
        self.requests = []
        self.spans = {}
        self.counters = {}
        self.info = {}
        self.trace = None
        self.setup_s = None
        self.window_start = None
        self.window_peak_bytes = None
        self.traced = False

    @contextlib.contextmanager
    def stage(self, name: str):
        """A set-up stage on the host clock, synchronised at its end."""
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.stages[name] = self.stages.get(name, 0.0) + (
            time.perf_counter() - t0)

    @contextlib.contextmanager
    def span(self, name: str):
        """A span around a call into one layer of the port: host clock,
        synchronised at its end, named ``spbench.<name>`` in a trace."""
        import torch

        with torch.profiler.record_function("spbench." + name):
            t0 = time.perf_counter()
            yield
            sync(self.device)
            self.spans.setdefault(name, []).append(
                (time.perf_counter() - t0, self.traced))

    def count(self, name: str, value) -> None:
        self.counters.setdefault(name, []).append((float(value), self.traced))

    @staticmethod
    def _untraced_first(rows) -> list:
        plain = [v for v, traced in rows if not traced]
        return plain or [v for v, _ in rows]

    def span_values(self, name: str) -> list:
        """Seconds of the span ``name``: of untraced requests where any."""
        return self._untraced_first(self.spans.get(name, []))

    def counter_values(self, name: str) -> list:
        return self._untraced_first(self.counters.get(name, []))


def card_line() -> str:
    """``name, power.limit`` of card 0 as ``nvidia-smi`` prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "unknown"


def load_native_libraries() -> list:
    """Load the port's CUDA kernel library and host library, building
    either one that the checkout does not hold yet; returns the file names
    of those it built."""
    from sparse_linear_tpu_torch.kernels import _build
    from sparse_linear_tpu_torch.utils import native

    built = [p.name for p in (_build.library_path(), native.library_path())
             if not p.is_file()]
    _build.load_library()
    native.load()
    return built


def _window(cell, driver, state, run, seconds: float, trace: bool) -> None:
    import torch

    from spbench import devtrace

    dev = torch.device(run.device)
    sync(dev)
    prof = None
    if trace:
        prof = devtrace.Profiler(dev)
        prof.start()
        run.traced = True
    trace_s = float(cell.workload.get("trace_seconds", 2.0))
    t0 = run.window_start = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < seconds:
        with torch.profiler.record_function("spbench.prepare"):
            driver.prepare(state, i)
            sync(dev)
        start = time.perf_counter()
        with torch.profiler.record_function("spbench.request"):
            ok = driver.serve(state, i)
            sync(dev)
        end = time.perf_counter()
        run.requests.append(SimpleNamespace(
            start=start, end=end, ok=bool(ok), traced=run.traced))
        i += 1
        if run.traced and end - prof.t0 >= trace_s:
            run.trace = prof.stop()
            run.traced = False
    if run.traced:
        run.trace = prof.stop()
        run.traced = False


def run_cell(root, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda:0", t_start: float | None = None,
             overrides=None, control: bool = False, log=None,
             stages=None) -> dict:
    """One run of the cell ``name``: returns the result line as a dict.

    ``device="cpu"`` is the internal entry the CPU tests drive at tiny
    sizes; the command line never takes it.  ``control=True`` runs the
    port in the precision below the configuration's (the control of
    ``correct``).  ``log`` receives the lines for standard error;
    ``stages`` holds set-up stages the caller timed before the call."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    cell = load_cell(root, name, overrides)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    run = Run(dev)
    run.stages.update(stages or {})
    run.stages["start"] = time.perf_counter() - t_start - sum(
        run.stages.values())
    with run.stage("cuda_init"):
        if on_card:
            torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
    built = []
    if on_card:
        with run.stage("kernel_library"):
            built = load_native_libraries()
    driver = importlib.import_module(
        f"spbench.drivers.{cell.workload['driver']}")
    dtype = cell.config["dtype"]
    if control:
        dtype = CONTROL_DTYPE[dtype]
    ctx = SimpleNamespace(config=cell.config, workload=cell.workload,
                          seed=int(seed), device=dev, run=run,
                          dtype=getattr(torch, dtype), log=log)
    state = driver.setup(ctx)
    sync(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    run.setup_s = time.perf_counter() - t_start
    log(f"spbench {name}: set-up {run.setup_s:.4f} s ("
        + ", ".join(f"{k} {v:.4f} s" for k, v in run.stages.items())
        + f"); built this run: {', '.join(built) or 'nothing'}")

    _window(cell, driver, state, run, seconds, trace)
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    run.window_peak_bytes = window_peak
    driver.release(state)
    if on_card:
        torch.cuda.empty_cache()

    values = driver.check(state)
    limits = cell.workload["limits"]
    checks = {k: {"value": float(v), "limit": float(limits[k])}
              for k, v in values.items()}
    correct = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        reader = load_file_module(
            cell.root / "spbench" / "metrics" / f"{spec['name']}.py",
            "spbench_metric_" + spec["name"].replace(".", "_").replace(
                "-", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}
    device_info = {
        "platform": "gpu" if on_card else dev.type,
        "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
        "count": int(cell.entry.get("chips", 1)),
        "memory_peak_bytes": int(max(setup_peak, window_peak)),
    }
    result = {"correct": correct, "attempted": len(run.requests),
              "failed": sum(not r.ok for r in run.requests),
              "metrics": metrics, "device": device_info}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["setup_stages"] = dict(run.stages)
    result["built"] = built
    result["card"] = card_line() if on_card else "cpu"
    result["checks"] = checks
    times = sorted(r.end - r.start for r in run.requests)
    log(f"spbench {name}: {len(run.requests)} requests in the window, "
        f"card {result['card']}; a request's time min {times[0]:.4f} "
        f"median {times[len(times) // 2]:.4f} max {times[-1]:.4f} s")
    for k, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILS"
        log(f"check {k} {c['value']!r} limit {c['limit']!r} {verdict}")
    return result


def main(argv, t_start: float, root: Path) -> int:
    ap = argparse.ArgumentParser(prog="spbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(root, args.workload)
    chips = int(cell.entry.get("chips", 1))
    t0 = time.perf_counter()

    import torch

    t1 = time.perf_counter()
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"spbench: the cell {args.workload} needs {chips} CUDA "
              f"device(s); torch sees {have}: no result", file=sys.stderr)
        return 1
    stages = {"import_torch": t1 - t0, "cuda_driver": time.perf_counter() - t1}
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", t_start, stages=stages)
    found = forbidden_modules()
    if found:
        print(f"spbench: the run loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0
