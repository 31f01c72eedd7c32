"""The port's profiling hooks (``sparse_linear_tpu_torch/utils/profiling.py``)
on the CPU: ``trace`` writes one Chrome trace file that names an
``annotate`` span and the port's SpMM inside it, and ``op_timings``
returns two positive times."""

import json

import pytest

torch = pytest.importorskip("torch")

from sparse_linear_tpu_torch.eig.pipeline import _structured_op  # noqa: E402
from sparse_linear_tpu_torch.utils import profiling  # noqa: E402
from sparse_linear_tpu_torch.utils.grids import poisson_2d  # noqa: E402


def test_trace_writes_a_file_naming_the_span(tmp_path):
    op = _structured_op(poisson_2d(8, dtype=torch.float64, device="cpu"))
    x = torch.ones((64, 3), dtype=torch.float64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("chebyshev:filter"):
            y = op(x)
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "chebyshev:filter" in names
    # the span holds the product's own ops (the plain DIA SpMM on the CPU)
    span = next(e for e in events if e.get("name") == "chebyshev:filter")
    inside = [e for e in events if e.get("ph") == "X"
              and e.get("name", "").startswith("aten::")
              and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]]
    assert inside
    assert "chebyshev:filter" in {e.key for e in prof.key_averages()}
    assert torch.equal(y, op(x))  # the trace leaves the result as it is


def test_annotate_is_a_plain_span_without_a_trace():
    with profiling.annotate("outside any trace"):
        t = torch.arange(4.0) * 2
    assert t.sum().item() == 12.0


def test_op_timings_returns_two_positive_floats():
    op = _structured_op(poisson_2d(8, dtype=torch.float64, device="cpu"))
    x = torch.ones((64, 3), dtype=torch.float64)
    first, steady = profiling.op_timings(op, x, iters=3)
    assert isinstance(first, float) and isinstance(steady, float)
    assert first > 0 and steady > 0


def test_op_timings_waits_on_nested_outputs():
    """A result that is a tuple of tensors (an EigResult-like NamedTuple)
    times like one tensor: the wait does not depend on the result's
    form."""
    def fn(v):
        return (v * 2, {"sum": v.sum()}, [v + 1])

    first, steady = profiling.op_timings(fn, torch.ones(10), iters=2)
    assert first > 0 and steady > 0
