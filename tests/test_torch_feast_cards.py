"""FEAST with its contour sharded over four cards, on the CPU at tiny
sizes: the answers against the closed-form 3D spectrum and against the
unsharded run, the per-card counters (``pipeline.last_run["cards"]``) and
the bytes copied between cards (``["exchange_bytes"]``) against their
formula, and the benchmark cell ``feast-3d-4card`` driven whole through
its harness, with its control and planted faults coming out not correct.

A four-card layout is stood in for by a mesh whose shards are the devices
``cpu``, ``cpu:1``, ``cpu:2`` and ``cpu:3``: torch computes on the CPU for
each, while the port, which tells shards apart by their devices, keeps a
site, a clock and the copies of each apart as on four cards.
"""

import dataclasses
import math
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_linear_tpu_torch.dist import Mesh, card_mesh  # noqa: E402
from sparse_linear_tpu_torch.eig import feast, pipeline  # noqa: E402
from sparse_linear_tpu_torch.formats.matrix import from_triples  # noqa: E402
from spbench import harness  # noqa: E402
from spbench.drivers.feast_slices import slice_edges  # noqa: E402
from spbench.operators import laplacian  # noqa: E402
from spbench.reference import product, spectrum, subspace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CELL = "feast-3d-4card"
SEED = 2 ** 31 + 4242
TOL = 1e-10
M0 = 24
NODES = 8
TINY = {"config": {"grid": [8, 8, 8]},
        "workload": {"m0": 16, "per_window": 8, "slack": 4, "windows": 30,
                     "trace_seconds": 0.2}}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
    pipeline.clear_pipeline_cache()


def _four_cards() -> Mesh:
    devices = np.empty(4, dtype=object)
    devices[:] = [torch.device("cpu")] + [torch.device("cpu", k)
                                          for k in (1, 2, 3)]
    return Mesh(devices, ("cp",))


def _problem(grid):
    """(A on the CPU, the triples, the closed-form spectrum, an interior
    window of about 12 eigenvalues whose edges split no cluster)."""
    n = math.prod(grid)
    rows, cols, vals = laplacian.triples(grid, torch.float64, "cpu")
    a = from_triples((n, n), rows, cols, vals).tocsr()
    lam = spectrum.eigenvalues(grid)
    edges = slice_edges(lam, 12, 4, 2)
    return a, (rows, cols, vals), lam, (edges[0], edges[1])


def _narrower(window, share):
    """Another window: the lower ``share`` of ``window`` (another contour,
    so nothing cached is reused)."""
    return window[0], window[0] + share * (window[1] - window[0])


def _params(grid, seed=7):
    return feast.FeastParams(tol=TOL, dims=tuple(grid),
                             backend="multifrontal", contour_points=NODES,
                             seed=seed)


@pytest.mark.parametrize("grid", [[10, 10, 10], [8, 10, 12]],
                         ids=["cube 10^3", "box 8x10x12"])
def test_sharded_eigsh_matches_the_closed_form_and_the_unsharded_run(grid):
    a, (rows, cols, vals), lam, window = _problem(grid)
    want = spectrum.inside(lam, window)
    plain = feast.eigsh(M0, window, a, _params(grid))
    plain_loops = len(pipeline.last_run["loops"])
    res = feast.eigsh(M0, window, a, _params(grid), mesh=_four_cards())
    run = pipeline.last_run
    assert run["mode"] == "sharded" and run["shard_mode"] == "batched"
    assert run["shards"] == ["cpu", "cpu:1", "cpu:2", "cpu:3"]
    assert res.info == feast.INFO_OK
    scale = max(abs(window[0]), abs(window[1]), 1.0)
    assert len(res.values) == len(want)
    assert np.abs(np.sort(res.values) - want).max() <= TOL * scale
    v = res.vectors.to(torch.float64)
    r = product.matvec(rows, cols, vals, v) - v * torch.as_tensor(
        res.values)[None, :]
    resid = (torch.linalg.vector_norm(r, dim=0)
             / torch.linalg.vector_norm(v, dim=0)).max()
    assert float(resid) / scale <= TOL
    assert subspace.orthonormality_gap(v) <= TOL
    assert len(run["loops"]) == plain_loops == res.iterations
    assert np.abs(res.values - plain.values).max() <= 1e-12


def test_reference_spectrum_is_the_dense_spectrum_of_its_triples():
    grid = [6, 7, 8]
    n = math.prod(grid)
    rows, cols, vals = laplacian.triples(grid, torch.float64, "cpu")
    dense = torch.zeros((n, n), dtype=torch.float64)
    dense.index_put_((rows, cols), vals, accumulate=True)
    assert torch.equal(dense, dense.T)
    got = torch.linalg.eigvalsh(dense).numpy()
    np.testing.assert_allclose(spectrum.eigenvalues(grid), got, rtol=0,
                               atol=1e-12)


def _exchange(n, nnz, m0, loops, others, nodes_a_card, cold):
    """Bytes a call copies between card 0 and the ``others`` cards: per
    loop the complex128 right-hand side out and the float64 sum back, per
    call each card's complex128 node values, and on the cold call the
    pattern (int32 pointers and indices, float64 values)."""
    per_card = loops * n * m0 * (16 + 8) + nodes_a_card * nnz * 16
    if cold:
        per_card += (n + 1) * 4 + nnz * 4 + nnz * 8
    return others * per_card


def test_cards_and_exchange_bytes_follow_the_layout():
    grid = [8, 10, 12]
    a, _, _, window = _problem(grid)
    n, nnz = a.shape[0], a.nnz
    feast.eigsh(M0, window, a, _params(grid))
    assert "cards" not in pipeline.last_run  # unsharded: no card counters
    assert "exchange_bytes" not in pipeline.last_run
    mesh = _four_cards()
    for cold, win in ((True, window), (False, _narrower(window, 0.9))):
        feast.eigsh(M0, win, a, _params(grid), mesh=mesh)
        run = pipeline.last_run
        cards = run["cards"]
        assert [c["device"] for c in cards] == ["cpu", "cpu:1", "cpu:2",
                                                "cpu:3"]
        assert all(c["nodes"] == 2 and c["mode"] == "batched"
                   and c["factor_s"] > 0 and c["filter_s"] > 0
                   and c["peak_bytes"] == 0 for c in cards)
        assert run["exchange_bytes"] == _exchange(
            n, nnz, M0, len(run["loops"]), 3, 2, cold)
    # every shard on one device: one card, nothing copied between cards
    feast.eigsh(M0, window, a, _params(grid),
                mesh=card_mesh(4, ("cp",), device="cpu"))
    run = pipeline.last_run
    assert [(c["device"], c["nodes"]) for c in run["cards"]] == [("cpu", 8)]
    assert run["exchange_bytes"] == 0


def test_card_spans_and_collective_spans_under_a_profiler():
    grid = [8, 8, 8]
    a, _, _, window = _problem(grid)
    feast.eigsh(M0, window, a, _params(grid), mesh=_four_cards())  # warm
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        feast.eigsh(M0, _narrower(window, 0.9), a, _params(grid),
                    mesh=_four_cards())
    names = [e.name for e in prof.events()]
    loops = len(pipeline.last_run["loops"])
    assert names.count("slt.feast.card") == 4 + 4 * loops
    assert names.count("slt.dist.psum") == loops
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # the unsharded contour opens neither
        feast.eigsh(M0, _narrower(window, 0.8), a, _params(grid))
    names = {e.name for e in prof.events()}
    assert not names & {"slt.feast.card", "slt.dist.psum", "slt.dist.gather"}


@pytest.mark.parametrize("sharded", [False, True],
                         ids=["one device", "four cards"])
def test_a_dropped_contour_is_freed_before_the_next_is_factored(
        sharded, monkeypatch):
    """At 68^3 on four cards the cached contour held 32.6 GB a card while
    the next was factored beside it, and card 0 ran out of memory."""
    grid = [8, 8, 8]
    a, _, _, window = _problem(grid)
    mesh = _four_cards() if sharded else None
    pipeline.clear_pipeline_cache()
    feast.eigsh(M0, window, a, _params(grid), mesh=mesh)
    (pipe,) = pipeline._PIPELINE_CACHE.values()
    (cached,) = pipe.contours.values()
    old = [weakref.ref(g[3].blocks[0]["lu"]) for g in cached.groups]
    del cached
    # room for the next contour only in place of the cached one
    monkeypatch.setattr(pipeline, "_budget",
                        lambda device, held=0.0: math.inf if held else 0.0)
    alive = []
    real = pipeline._Contour.__init__

    def init(self, *args, **kw):
        alive.append([r() is not None for r in old])
        real(self, *args, **kw)

    monkeypatch.setattr(pipeline._Contour, "__init__", init)
    feast.eigsh(M0, _narrower(window, 0.9), a, _params(grid), mesh=mesh)
    assert alive == [[False] * len(old)]
    assert len(pipe.contours) == 1


def _serial(steps):
    """The cards' steppers drained one card after another: the order the
    sharded contour ran in before its cards were launched in turn."""
    for stepper in steps.values():
        for _ in stepper:
            pass


@pytest.mark.parametrize("grid,batching", [
    ([10, 10, 10], "auto"), ([8, 10, 12], "auto"), ([10, 10, 10], "loop")],
    ids=["cube 10^3", "box 8x10x12", "cube 10^3 per-node"])
def test_cards_in_turn_are_bitwise_the_serial_drain(grid, batching,
                                                    monkeypatch):
    a, _, _, window = _problem(grid)
    params = dataclasses.replace(_params(grid), contour_batching=batching)
    runs = []
    for drain in (pipeline._in_turn, _serial):
        pipeline.clear_pipeline_cache()
        monkeypatch.setattr(pipeline, "_in_turn", drain)
        res = feast.eigsh(M0, window, a, params, mesh=_four_cards())
        runs.append((res, dict(pipeline.last_run)))
    (got, run), (want, serial) = runs
    assert run["shard_mode"] == ("per-node" if batching == "loop"
                                 else "batched")
    assert got.info == want.info == feast.INFO_OK
    np.testing.assert_array_equal(got.values, want.values)
    assert torch.equal(got.vectors, want.vectors)
    assert got.iterations == want.iterations == len(run["loops"])
    assert run["exchange_bytes"] == serial["exchange_bytes"]


def test_cards_launch_in_turn_after_every_copy_to_them(monkeypatch):
    """A launch trace of a cold sharded call: ``_bucket_factor`` calls and
    solve steps, each tagged with the card whose stepper ran it, copies to
    another card, and the start and end of each phase run in turn."""
    from sparse_linear_tpu_torch.solve import multifrontal as mf

    grid = [8, 8, 8]
    a, _, _, window = _problem(grid)
    log, card = [], [None]
    cards = ["cpu", "cpu:1", "cpu:2", "cpu:3"]

    def tagged(dev, stepper):
        while True:
            card[0] = str(dev)
            try:
                next(stepper)
            except StopIteration:
                return
            yield

    real_turn = pipeline._in_turn

    def in_turn(steps):
        log.append(("phase", None))
        real_turn({d: tagged(d, s) for d, s in steps.items()})
        log.append(("end", None))

    real_bucket = mf._bucket_factor

    def bucket(*args, **kw):
        log.append(("factor", card[0]))
        return real_bucket(*args, **kw)

    real_solve = mf._solve_run

    def solve_run(*args, **kw):
        steps = real_solve(*args, **kw)
        while True:
            try:
                next(steps)
            except StopIteration as stop:
                return stop.value
            log.append(("solve", card[0]))
            yield

    real_to = torch.Tensor.to

    def to(self, *args, **kw):
        dest = kw.get("device", args[0] if args else None)
        if isinstance(dest, (str, torch.device)) and \
                torch.device(dest) != self.device:
            log.append(("copy", str(torch.device(dest))))
        return real_to(self, *args, **kw)

    monkeypatch.setattr(pipeline, "_in_turn", in_turn)
    monkeypatch.setattr(mf, "_bucket_factor", bucket)
    monkeypatch.setattr(mf, "_solve_run", solve_run)
    monkeypatch.setattr(torch.Tensor, "to", to)
    pipeline.clear_pipeline_cache()
    res = feast.eigsh(M0, window, a, _params(grid), mesh=_four_cards())
    monkeypatch.undo()
    loops = res.iterations
    assert res.info == feast.INFO_OK
    starts = [i for i, (what, _) in enumerate(log) if what == "phase"]
    ends = [i for i, (what, _) in enumerate(log) if what == "end"]
    assert len(starts) == len(ends) == 1 + loops
    buckets = len(mf.analyze(a, dims=tuple(grid)).schedule["flat"])
    before = 0
    for k, (lo, hi) in enumerate(zip(starts, ends)):
        # the phase's copies: to each other card, all before its launches
        copied = {dest for what, dest in log[before:lo] if what == "copy"}
        assert copied == set(cards[1:])
        inside = log[lo + 1:hi]
        kind = "factor" if k == 0 else "solve"
        assert all(what == kind for what, _ in inside)
        # one bucket a card in turn: the factor's buckets, or the forward
        # and backward passes of a real pencil's solves
        rounds = buckets if k == 0 else 2 * buckets
        assert [dest for _, dest in inside] == cards * rounds
        before = hi + 1


def test_the_phases_run_in_turn_only_across_cards(monkeypatch):
    """``_in_turn`` runs each phase of a contour whose groups sit on more
    than one card: the factorization and every loop's filter cold, the
    filters alone once the contour is cached, and nothing without a mesh
    or with four shards on one device."""
    grid = [8, 8, 8]
    a, _, _, window = _problem(grid)
    calls = []
    real = pipeline._in_turn

    def counted(steps):
        calls.append(len(steps))
        real(steps)

    monkeypatch.setattr(pipeline, "_in_turn", counted)
    res = feast.eigsh(M0, window, a, _params(grid), mesh=_four_cards())
    assert calls == [4] * (1 + res.iterations)
    # the contour cached: only the filters run in turn
    calls.clear()
    res = feast.eigsh(M0, window, a, _params(grid), mesh=_four_cards())
    assert calls == [4] * res.iterations
    for mesh in (None, card_mesh(4, ("cp",), device="cpu")):
        calls.clear()
        feast.eigsh(M0, _narrower(window, 0.9), a, _params(grid), mesh=mesh)
        assert calls == []


def test_stepped_factors_keep_full_f32_to_their_own_steps(monkeypatch):
    """Two f32 factorizations advanced in turn: every bucket runs under
    full f32 products, and between steps the caller's setting holds."""
    from sparse_linear_tpu_torch.solve import multifrontal as mf
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    a = poisson_2d(12, dtype=torch.float32, device="cpu")
    sym = mf.analyze(a, dims=(12, 12))
    seen = []
    real = mf._bucket_factor

    def bucket(*args, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return real(*args, **kw)

    monkeypatch.setattr(mf, "_bucket_factor", bucket)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("medium")
    try:
        steps = {k: mf.factor_batched_steps(torch.stack([a.data * k]), sym)
                 for k in (1.0, 2.0)}
        between = []
        live = list(steps.values())
        while live:
            for s in tuple(live):
                try:
                    next(s)
                except StopIteration:
                    live.remove(s)
                between.append(torch.get_float32_matmul_precision())
    finally:
        torch.set_float32_matmul_precision(before)
    assert len(seen) == 2 * len(sym.schedule["flat"])
    assert set(seen) == {"highest"}
    assert set(between) == {"medium"}


def _run(trace=False, **kw):
    return harness.run_cell(ROOT, CELL, SEED, 0.3, trace, device="cpu",
                            overrides=TINY, log=lambda s: None, **kw)


def test_cell_runs_and_is_correct_on_the_cpu():
    res = _run()
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "eig_s"}
    assert set(res["checks"]) == {"count", "eig_err", "resid", "orth"}


def test_traced_cell_reports_the_card_metrics():
    res = _run(trace=True)
    assert res["correct"]
    got = res["metrics"]
    # on the CPU every shard shares one device: one card, nothing copied,
    # and no allocator peak to read
    assert set(got) == {"feast.card_factor_s", "feast.card_overlap",
                        "feast.exchange_gb"}
    assert got["feast.card_factor_s"]["value"] > 0
    assert got["feast.card_overlap"]["value"] == pytest.approx(1.0, rel=0.5)
    assert got["feast.exchange_gb"]["value"] == 0


def test_cell_control_comes_out_not_correct():
    assert not _run(control=True)["correct"]


def _psum_drops_a_card(monkeypatch):
    from sparse_linear_tpu_torch.dist import collectives

    real = collectives.psum
    monkeypatch.setattr(collectives, "psum",
                        lambda values, device: real(values[:-1], device))


def _eigsh_changed(monkeypatch, change):
    real = feast.eigsh

    def wrapped(m0, interval, a, params, **kw):
        return change(real(m0, interval, a, params, **kw))

    monkeypatch.setattr(feast, "eigsh", wrapped)


def _pair_dropped(monkeypatch):
    _eigsh_changed(monkeypatch, lambda r: r._replace(
        values=r.values[1:], vectors=r.vectors[:, 1:],
        n_found=r.n_found - 1))


def _value_moved(monkeypatch):
    def change(r):
        values = r.values.copy()
        values[-1] += 1e-6
        return r._replace(values=values)

    _eigsh_changed(monkeypatch, change)


FAULTS = [("a card's quadrature sum left out of the psum",
           _psum_drops_a_card),
          ("a pair dropped", _pair_dropped),
          ("a value moved", _value_moved)]


@pytest.mark.parametrize("plant", [p for _, p in FAULTS],
                         ids=[f for f, _ in FAULTS])
def test_a_fault_in_the_sharded_path_is_caught(plant, monkeypatch):
    plant(monkeypatch)
    assert not _run()["correct"]
