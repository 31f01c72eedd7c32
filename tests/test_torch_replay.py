"""The multifrontal replay path on the CPU (``solve/multifrontal._Plan``).

On CPU tensors the path never engages: ``factor``/``solve`` run eagerly
and the counters stay at zero.  The plan's keying, when it records, and
its ownership logic are device-independent, so they run here with a
stand-in for the CUDA graph, engaged on the CPU: a "capture" that runs the
region eagerly and a "replay" that runs it again and writes the results
into the first run's output tensors, as a graph replay rewrites its static
outputs.  The card's own tests of the path are
in ``test_torch_cuda.py``.
"""

import threading
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_linear_tpu_torch.formats.matrix import from_triples  # noqa: E402
from sparse_linear_tpu_torch.solve import multifrontal as mf  # noqa: E402
from sparse_linear_tpu_torch.utils.grids import poisson_2d  # noqa: E402

G = 12


def _field(seed, dtype=torch.float64, g=G):
    """The g**2 five-point pattern with the values of a lognormal
    conductivity: off-diagonal -harmonic mean of the two nodes' kappa,
    diagonal the sum of its row's faces plus kappa (SPD)."""
    a = poisson_2d(g, dtype=torch.float64, device="cpu")
    rows, cols = a.row_ids().numpy(), a.indices.numpy()
    kappa = np.exp(np.random.default_rng(seed).standard_normal(g * g))
    kr, kc = kappa[rows], kappa[cols]
    vals = np.where(rows != cols, -2 * kr * kc / (kr + kc), 0.0)
    diag = kappa - np.bincount(rows, weights=vals, minlength=g * g)
    vals = np.where(rows == cols, diag[rows], vals)
    return from_triples((g * g, g * g), rows, cols,
                        torch.as_tensor(vals).to(dtype), device="cpu").tocsr()


def _rhs(seed, k=None, g=G):
    shape = (g * g,) if k is None else (g * g, k)
    return torch.randn(shape, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(seed))


def _resid(a, x, b):
    ax = a.todense() @ x
    return float(torch.linalg.vector_norm(ax - b)
                 / torch.linalg.vector_norm(b))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


def _stand_in(run, device):
    """A capture that runs ``run`` eagerly; its replay runs it again and
    copies the results into the first outputs (broadcast views, whose
    values do not depend on the input, are left as they are)."""
    out = run()

    def replay():
        for dst, src in zip(_leaves(out), _leaves(run())):
            if 0 not in dst.stride():
                dst.copy_(src)

    return out, replay


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(mf, "_cuda_graph", _stand_in)
    monkeypatch.setattr(mf, "_captures", lambda device: True)


def _delta(before):
    now = mf.replay_counts()
    return {k: now[k] - before[k] for k in now}


def _eager(sym, a, b, scale="none"):
    """The batched eager path on one value set: (its factors, x)."""
    fb = mf.factor_batched(a.data[None], sym, kind="cholesky", scale=scale)
    x = mf.solve_batched(fb, b.reshape(b.shape[0], -1)[None].to(
        torch.promote_types(fb.dtype, b.dtype)))[0]
    return fb, x.reshape(b.shape)


def test_cpu_tensors_never_engage_the_replay():
    sym = mf.analyze(_field(0), dims=(G, G))
    before = mf.replay_counts()
    for seed in (1, 2):
        a, b = _field(seed), _rhs(seed)
        f = mf.factor(a, sym, kind="cholesky")
        x = mf.solve(f, b)
        fb, xb = _eager(sym, a, b)
        for bidx, blk in f.blocks.items():
            for name, t in blk.items():
                assert torch.equal(t, fb.blocks[bidx][name][0])
        assert torch.equal(x, xb)
        assert _resid(a, x, b) <= 1e-12
        assert f._plan is None
    assert sym._plans == {}
    assert all(v == 0 for v in _delta(before).values())


def test_replay_matches_the_eager_path_and_counts(stand_in):
    """The first factor runs eagerly, the second captures; the first solve
    on a replay's factors runs eagerly, the second (same width) captures."""
    sym = mf.analyze(_field(0), dims=(G, G))
    before = mf.replay_counts()
    for i, seed in enumerate((1, 2, 3, 4)):
        a, b = _field(seed), _rhs(10 + seed)
        f = mf.factor(a, sym, kind="cholesky")
        assert (f._plan is None) == (i == 0)
        x = mf.solve(f, b)
        fb, xb = _eager(sym, a, b)
        for bidx, blk in f.blocks.items():
            for name, t in blk.items():
                assert torch.equal(t, fb.blocks[bidx][name][0])
        assert torch.equal(x, xb)
        assert _resid(a, x, b) <= 1e-12
        assert not f.breakdown
        del f
    assert _delta(before) == {"captures": 1, "solve_captures": 1,
                              "factor_replays": 3, "solve_replays": 2,
                              "detaches": 0}
    assert len(sym._plans) == 1


def test_one_shot_factors_and_new_patterns_record_nothing(stand_in):
    """A single factor of a pattern, however many solves it serves, and a
    new symbolic a call run eagerly: no graph, no pool."""
    before = mf.replay_counts()
    for seed in (1, 2, 3):
        a, b = _field(seed), _rhs(seed)
        sym = mf.analyze(a, dims=(G, G))
        f = mf.factor(a, sym, kind="cholesky")
        assert f._plan is None
        for _ in range(3):
            x = mf.solve(f, b)
        assert torch.equal(x, _eager(sym, a, b)[1])
        (plan,) = sym._plans.values()
        assert plan.replay is None and plan.solve_graph is None
    assert all(v == 0 for v in _delta(before).values())


def test_kept_factors_are_detached_before_the_next_replay(stand_in):
    sym = mf.analyze(_field(0), dims=(G, G))
    a1, a2, b = _field(1), _field(2), _rhs(5)
    mf.factor(a1, sym, kind="cholesky")  # the key's first: eager
    before = mf.replay_counts()
    f1 = mf.factor(a1, sym, kind="cholesky")
    f2 = mf.factor(a2, sym, kind="cholesky")
    assert _delta(before)["detaches"] == 1
    assert f1._plan is None and f2._plan is not None
    for bidx, blk in f1.blocks.items():
        for name, t in blk.items():
            assert t.data_ptr() != f2.blocks[bidx][name].data_ptr()
    x1 = mf.solve(f1, b)  # eager now
    x2 = mf.solve(f2, b)  # eager: the first solve on these factors
    x2r = mf.solve(f2, b)  # captured and replayed
    assert _resid(a1, x1, b) <= 1e-12 and _resid(a2, x2r, b) <= 1e-12
    assert torch.equal(x1, _eager(sym, a1, b)[1])
    assert torch.equal(x2, x2r)
    d = _delta(before)
    assert d["solve_replays"] == 1 and d["factor_replays"] == 2
    # dropped factors are not copied
    del f2
    mf.factor(a1, sym, kind="cholesky")
    assert _delta(before)["detaches"] == 1


def test_kept_solution_is_unchanged_by_the_next_solve(stand_in):
    sym = mf.analyze(_field(0), dims=(G, G))
    mf.factor(_field(1), sym, kind="cholesky")
    f = mf.factor(_field(1), sym, kind="cholesky")
    before = mf.replay_counts()
    mf.solve(f, _rhs(1))
    x2 = mf.solve(f, _rhs(2))  # a replay's output
    kept = x2.clone()
    mf.solve(f, _rhs(3))
    f = mf.factor(_field(2), sym, kind="cholesky")
    mf.solve(f, _rhs(4))
    assert _delta(before)["solve_replays"] == 3
    assert torch.equal(x2, kept)


def test_to_copies_a_replays_blocks(stand_in):
    sym = mf.analyze(_field(0), dims=(G, G))
    a1, b = _field(1), _rhs(4)
    mf.factor(a1, sym, kind="cholesky")
    f = mf.factor(a1, sym, kind="cholesky")
    assert f._plan is not None
    moved = f.to("cpu")
    del f
    assert moved._plan is None
    mf.factor(_field(2), sym, kind="cholesky")
    assert _resid(a1, mf.solve(moved, b), b) <= 1e-12


@pytest.mark.parametrize("keep", [False, True])
def test_row_scale_of_a_replay_is_the_callers(stand_in, keep):
    """A row_scale taken from a replay's factors is unchanged by the next
    factor, whether the factors are kept (and detached) or dropped."""
    sym = mf.analyze(_field(0), dims=(G, G))
    a1, a2 = _field(1), _field(2)
    mf.factor(a1, sym, kind="cholesky", scale="sum")
    f1 = mf.factor(a1, sym, kind="cholesky", scale="sum")
    assert f1._plan is not None
    r1 = f1.row_scale
    kept = r1.clone()
    if not keep:
        del f1
    f2 = mf.factor(a2, sym, kind="cholesky", scale="sum")
    assert torch.equal(r1, kept)
    assert not torch.equal(f2.row_scale, kept)
    if keep:
        assert torch.equal(f1.row_scale, kept)


def test_plan_is_keyed_by_dtype_and_scale_and_solve_by_width(stand_in):
    sym = mf.analyze(_field(0), dims=(G, G))
    before = mf.replay_counts()
    for dtype, scale in ((torch.float64, "none"), (torch.float32, "none"),
                         (torch.float64, "sum"), (torch.float64, "none")):
        a = _field(1, dtype)
        for _ in range(2):
            f = mf.factor(a, sym, kind="cholesky", scale=scale)
            b = _rhs(1)
            x = mf.solve(f, b)
            assert x.shape == b.shape and x.dtype == torch.float64
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            assert _resid(a.map_values(lambda v: v.double()), x, b) <= tol
            assert torch.equal(x, _eager(sym, a, b, scale)[1])
            del f
    d = _delta(before)
    # each key's first factor eager, its second captured; the repeated
    # key replays twice, and its solve (width 1, f64) repeats there
    assert d["captures"] == 3 and d["factor_replays"] == 5
    assert d["solve_captures"] == 1 and d["solve_replays"] == 2
    assert d["detaches"] == 0
    assert {k[1:] for k in sym._plans} == {
        (torch.float64, "none"), (torch.float32, "none"),
        (torch.float64, "sum")}


def test_solve_graph_records_a_repeated_width_and_keeps_one(stand_in):
    """A width is recorded when it repeats the previous solve's; the plan
    keeps only the latest recorded width's graph and solves the others
    eagerly."""
    sym = mf.analyze(_field(0), dims=(G, G))
    a = _field(1)
    mf.factor(a, sym, kind="cholesky")
    f = mf.factor(a, sym, kind="cholesky")
    plan = f._plan
    before = mf.replay_counts()
    dropped = []
    for i, k in enumerate((1, 1, 3, 1, 3, 3, 1, 1)):
        graph = plan.solve_graph
        b = _rhs(i, k=k)
        x = mf.solve(f, b)
        assert torch.equal(x, _eager(sym, a, b)[1])
        if graph is not None and plan.solve_graph is not graph:
            dropped.append(weakref.ref(graph[2]))
    assert _delta(before) == {"captures": 0, "solve_captures": 3,
                              "factor_replays": 0, "solve_replays": 4,
                              "detaches": 0}
    assert plan.solve_graph[0] == (1, torch.float64)
    del graph
    assert len(dropped) == 2 and all(r() is None for r in dropped)


def test_other_paths_stay_eager(stand_in):
    sym = mf.analyze(_field(0), dims=(G, G))
    a, b = _field(1), _rhs(7, k=2)
    before = mf.replay_counts()
    f = mf.factor(a, sym, kind="lu")
    assert f._plan is None
    mf.solve(f, b)
    fb = mf.factor_batched(torch.stack([a.data, a.data]), sym,
                           kind="cholesky")
    mf.solve_batched(fb, torch.stack([b, b]))
    assert all(v == 0 for v in _delta(before).values())
    assert sym._plans == {}
    # on replayed factors: the trans solve and solve_part run eagerly
    mf.factor(a, sym, kind="cholesky")
    f = mf.factor(a, sym, kind="cholesky")
    assert f._plan is not None
    before = mf.replay_counts()
    for _ in range(2):
        xh = mf.solve(f, b, trans=True)
    assert torch.equal(xh, _eager(sym, a, b)[1])
    z = mf.solve_part(f, b[torch.as_tensor(sym.perm, dtype=torch.long)], "L")
    assert z.shape == b.shape
    assert all(v == 0 for v in _delta(before).values())


def test_changed_pattern_is_rejected_before_the_plan(stand_in):
    sym = mf.analyze(_field(0), dims=(G, G))
    for _ in range(2):
        mf.factor(_field(1), sym, kind="cholesky")
    other = poisson_2d(G, G + 1, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        mf.factor(other, sym, kind="cholesky")
    wrong = _field(1)
    wrong = from_triples(wrong.shape, wrong.row_ids().numpy()[:-1],
                         wrong.indices.numpy()[:-1], wrong.data[:-1],
                         device="cpu").tocsr()
    with pytest.raises(ValueError, match="pattern does not match"):
        mf.factor(wrong, sym, kind="cholesky")


def test_replay_opens_its_spans(stand_in):
    """The replay path's spans in order (level spans left out: the stand-in
    runs the level loop again where a graph replay opens none)."""
    sym = mf.analyze(_field(0), dims=(G, G))
    a, b = _field(1), _rhs(1)

    def names():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            mf.solve(mf.factor(a, sym, kind="cholesky"), b)
        return [e.name for e in sorted(
            (e for e in prof.events() if e.name.startswith("slt.")
             and not e.name.endswith(".level")),
            key=lambda e: e.time_range.start)]

    assert names() == ["slt.mf.factor", "slt.mf.solve"]
    assert names() == ["slt.mf.factor", "slt.mf.capture",
                       "slt.mf.factor.replay", "slt.mf.solve"]
    assert names() == ["slt.mf.factor", "slt.mf.factor.replay",
                       "slt.mf.solve", "slt.mf.capture",
                       "slt.mf.solve.replay"]
    assert names() == ["slt.mf.factor", "slt.mf.factor.replay",
                       "slt.mf.solve", "slt.mf.solve.replay"]


def test_threads_sharing_a_symbolic_take_turns(stand_in):
    """Threads that refactor and solve on one symbolic each get their own
    system's answer: the plan's lock keeps a value set's copy in, its
    replay and its factors' detach together."""
    sym = mf.analyze(_field(0), dims=(G, G))
    fields = [_field(seed) for seed in range(1, 5)]
    b = _rhs(9)
    for _ in range(2):
        mf.factor(fields[0], sym, kind="cholesky")
    worst = [0.0] * len(fields)

    def work(i):
        for _ in range(4):
            f = mf.factor(fields[i], sym, kind="cholesky")
            x = mf.solve(f, b)
            worst[i] = max(worst[i], _resid(fields[i], x, b))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(fields))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert max(worst) <= 1e-12
