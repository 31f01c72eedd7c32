"""The port's spans at its layer boundaries (``utils/profiling.annotate``)
on the CPU at tiny sizes: which ``slt.*`` spans each entry point opens
under a profiler, how they nest, and that outside a profiler no span runs
(``record_function`` is never called) and every result is bitwise the
same."""

from collections import Counter

import pytest

torch = pytest.importorskip("torch")

from sparse_linear_tpu_torch.eig import feast  # noqa: E402
from sparse_linear_tpu_torch.formats.matrix import from_triples  # noqa: E402
from sparse_linear_tpu_torch.solve import cg as cg_mod  # noqa: E402
from sparse_linear_tpu_torch.solve import multifrontal as mf  # noqa: E402
from sparse_linear_tpu_torch.utils import profiling  # noqa: E402
from sparse_linear_tpu_torch.utils.grids import poisson_2d  # noqa: E402

N = 16
ANALYZE_STAGES = ["slt.mf.analyze.order", "slt.mf.analyze.symmetrize",
                  "slt.mf.analyze.symbolic", "slt.mf.analyze.schedule",
                  "slt.mf.analyze.maps"]


def _op():
    return poisson_2d(N, dtype=torch.float64, device="cpu")


def _rhs():
    return torch.linspace(-1.0, 1.0, N * N, dtype=torch.float64)


def _params():
    return feast.FeastParams(dims=(N, N), backend="multifrontal")


def _traced(fn):
    """(fn's result, the slt.* events its call recorded, in start order)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events = sorted((e for e in prof.events() if e.name.startswith("slt.")),
                    key=lambda e: e.time_range.start)
    return out, events


def _ancestors(event) -> list:
    names = []
    while event.cpu_parent is not None:
        event = event.cpu_parent
        names.append(event.name)
    return names


def test_cg_opens_one_span_a_call():
    a, b = _op(), _rhs()

    def two_solves():
        return [cg_mod.cg(a.__matmul__, b, tol=1e-10, maxiter=500)
                for _ in range(2)]

    res, events = _traced(two_solves)
    assert all(r.converged and r.iterations > 1 for r in res)
    assert [e.name for e in events] == ["slt.cg", "slt.cg"]


def test_analyze_opens_its_five_stages_inside_its_span():
    sym, events = _traced(lambda: mf.analyze(_op(), dims=(N, N)))
    assert sym.n == N * N
    assert [e.name for e in events] == ["slt.mf.analyze"] + ANALYZE_STAGES
    for e in events[1:]:
        assert _ancestors(e)[0] == "slt.mf.analyze"


def test_general_graph_order_opens_its_symmetrize_span():
    """Without dims the order stage builds the unpermuted pattern of
    A + A^T + I for AMD, as its own span inside the stage's."""
    sym, events = _traced(lambda: mf.analyze(_op()))
    assert sym.n == N * N
    names = [e.name for e in events]
    assert names == (["slt.mf.analyze", "slt.mf.analyze.order",
                      "slt.mf.analyze.order.symmetrize"]
                     + ANALYZE_STAGES[1:])
    assert _ancestors(events[2])[:2] == ["slt.mf.analyze.order",
                                         "slt.mf.analyze"]


@pytest.mark.parametrize("kind", ["cholesky", "lu"])
def test_factor_and_solve_open_one_level_span_per_tree_level(kind):
    a = _op()
    sym = mf.analyze(a, dims=(N, N))
    levels = len(sym.schedule["level_buckets"])
    assert levels > 2
    fac, events = _traced(lambda: mf.factor(a, sym, kind=kind))
    assert Counter(e.name for e in events) == {
        "slt.mf.factor": 1, "slt.mf.factor.level": levels}
    assert all(_ancestors(e) == ["slt.mf.factor"] for e in events[1:])
    _, events = _traced(lambda: mf.solve(fac, _rhs()))
    # a forward and a backward pass over the levels
    assert Counter(e.name for e in events) == {
        "slt.mf.solve": 1, "slt.mf.solve.level": 2 * levels}
    assert all(_ancestors(e) == ["slt.mf.solve"] for e in events[1:])


def test_batched_factor_and_solve_open_the_same_spans():
    a = _op()
    sym = mf.analyze(a, dims=(N, N))
    levels = len(sym.schedule["level_buckets"])
    stack = torch.stack([a.data, 2.0 * a.data])
    fac, events = _traced(lambda: mf.factor_batched(stack, sym))
    assert Counter(e.name for e in events) == {
        "slt.mf.factor": 1, "slt.mf.factor.level": levels}
    rhs = torch.stack([_rhs(), _rhs()])[:, :, None]
    _, events = _traced(lambda: mf.solve_batched(fac, rhs))
    assert Counter(e.name for e in events) == {
        "slt.mf.solve": 1, "slt.mf.solve.level": 2 * levels}


def _eigsh():
    return feast.eigsh(10, (0.0, 0.3), _op(), _params())


def _identity():
    ar = torch.arange(N * N)
    return from_triples((N * N, N * N), ar, ar,
                        torch.ones(N * N, dtype=torch.float64)).tocsr()


def _diagonal():
    ar = torch.arange(N * N)
    return from_triples((N * N, N * N), ar, ar,
                        torch.linspace(1.0, 2.0, N * N,
                                       dtype=torch.float64)).tocsr()


@pytest.mark.parametrize("b_kind,fingerprints", [
    (None, 1), ("identity", 1), ("diagonal", 2)],
    ids=["eigsh", "geigsh identity", "geigsh diagonal"])
def test_feast_opens_one_call_span_and_a_fingerprint_a_matrix(
        b_kind, fingerprints):
    from sparse_linear_tpu_torch.eig import pipeline

    a = _op()
    if b_kind is None:
        def call():
            return feast.eigsh(10, (0.0, 0.3), a, _params())
    else:
        b = _identity() if b_kind == "identity" else _diagonal()

        def call():
            return feast.geigsh(10, (0.0, 0.3), a, b, _params())
    pipeline.clear_pipeline_cache()
    res, events = _traced(call)
    assert res.info == feast.INFO_OK and res.n_found > 0
    count = Counter(e.name for e in events)
    # the pipeline cache's key: A's fingerprint, and B's unless it is the
    # identity
    assert count["slt.feast.eigsh"] == 1
    assert count["slt.feast.fingerprint"] == fingerprints
    assert count["slt.feast.filter"] == count["slt.feast.rr"] == \
        res.iterations
    assert count["slt.feast.eigh"] == 2 * res.iterations
    assert count["slt.feast.factor"] >= 1
    assert events[0].name == "slt.feast.eigsh"
    assert all("slt.feast.eigsh" in _ancestors(e) for e in events[1:])
    for e in events:
        if e.name == "slt.feast.eigh":
            assert _ancestors(e)[0] == "slt.feast.rr"
    pipeline.clear_pipeline_cache()


def test_assembly_opens_its_two_spans():
    a = _op().tocoo()
    csr, events = _traced(lambda: from_triples(
        a.shape, a.row, a.col, a.data).tocsr())
    assert [e.name for e in events] == ["slt.format.from_triples",
                                        "slt.format.tocsr"]
    assert torch.equal(csr.data, _op().data)


def _every_entry_point():
    """cg, assembly, analyze, factor, solve and eigsh, each result as host
    arrays."""
    from sparse_linear_tpu_torch.eig import pipeline

    a, b = _op(), _rhs()
    coo = a.tocoo()
    csr = from_triples(coo.shape, coo.row, coo.col, coo.data).tocsr()
    x_cg = cg_mod.cg(csr.__matmul__, b, tol=1e-10, maxiter=500).x
    sym = mf.analyze(csr, dims=(N, N))
    x_mf = mf.solve(mf.factor(csr, sym, kind="cholesky"), b)
    pipeline.clear_pipeline_cache()
    eig = _eigsh()
    pipeline.clear_pipeline_cache()
    return [csr.data, x_cg, x_mf, torch.as_tensor(eig.values), eig.vectors]


def test_no_span_runs_outside_a_profiler(monkeypatch):
    """Outside any profiler ``annotate`` never reaches ``record_function``
    and every result is bitwise the one a traced run returns."""
    traced, events = _traced(_every_entry_point)
    assert events

    def refuse(*args, **kwargs):
        raise AssertionError("record_function ran outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    plain = _every_entry_point()
    for t, p in zip(traced, plain):
        assert torch.equal(t, p)


def test_annotate_formats_its_args_only_under_a_profiler():
    class Loud:
        def __str__(self):
            raise AssertionError("args formatted outside a profiler")

    with profiling.annotate("slt.test", (Loud(), "forward")):
        pass

    def span():
        with profiling.annotate("slt.test", (3, "forward")):
            pass

    _, events = _traced(span)
    assert [e.name for e in events] == ["slt.test"]
