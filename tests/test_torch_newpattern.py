"""A new 2D finite-element mesh with every request: the benchmark's mesh
generator against the finite-element identities, the port's staged
no-dims path (analyze with its own ordering, Cholesky factor, solve)
against a dense solve of the same triples, the record ``analyze`` keeps
on its symbolic, and the cell ``direct-newpattern`` driven whole through
its harness on the CPU at its tiny size, with its control and planted
faults coming out not correct.

The ``cuda`` tests at the end run the cell's requests at 2^16 nodes on
the card; this file imports no JAX, so there they run as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_newpattern.py
"""

import json
import math
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from sparse_linear_tpu_torch.formats.matrix import from_triples  # noqa: E402
from sparse_linear_tpu_torch.solve import api  # noqa: E402
from sparse_linear_tpu_torch.solve import multifrontal as mf  # noqa: E402
from spbench import harness  # noqa: E402
from spbench.drivers import direct_newpattern as driver  # noqa: E402
from spbench.operators import mesh2d  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CELL = "direct-newpattern"
SEED = 2 ** 31 + 2026
WORKLOAD = json.loads(
    (ROOT / "spbench" / "workloads" / f"{CELL}.json").read_text())
CONFIG = json.loads(
    (ROOT / "spbench" / "configs" / "fem2d-newmesh-f64.json").read_text())
TINY = WORKLOAD["tiny"]
STAGES = ("order_s", "symmetrize_s", "symbolic_s", "schedule_s", "maps_s")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: several test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _gen(seed, device="cpu"):
    return torch.Generator(device=device).manual_seed(seed)


def _mesh(seed, nodes=500):
    return mesh2d.mesh(nodes, CONFIG["aspect"], CONFIG["jitter"], _gen(seed),
                       "cpu")


def _dense(n, rows, cols, vals):
    a = torch.zeros((n, n), dtype=torch.float64)
    a.index_put_((rows, cols), vals, accumulate=True)
    return a


def _assembled(m, local):
    rows = m.tris[:, :, None].expand(-1, 3, 3).reshape(-1)
    cols = m.tris[:, None, :].expand(-1, 3, 3).reshape(-1)
    return _dense(m.n, rows, cols, local.reshape(-1))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_every_triangle_keeps_a_fifth_of_its_area(seed):
    m = _mesh(seed, nodes=3000)
    _, _, area = mesh2d.local_matrices(m.xy, m.tris)
    h2 = 1.0 / ((m.nx - 1) * (m.ny - 1))
    assert len(m.tris) == 2 * (m.nx - 1) * (m.ny - 1)
    # the jitter bound: no triangle below a fifth of the unjittered h^2/2
    assert float(area.min()) >= 0.2 * h2 / 2
    assert 0.5 <= m.nx / m.ny * (m.ny - 1) / (m.nx - 1) <= 2.0 + 1e-9
    assert 3000 * 0.95 <= m.n <= 3000 * 1.05


def test_stiffness_annihilates_constants_and_mass_sums_to_the_area():
    m = _mesh(4)
    stiff, mass, area = mesh2d.local_matrices(m.xy, m.tris)
    k = _assembled(m, stiff)
    ones = torch.ones(m.n, dtype=torch.float64)
    assert float((k @ ones).abs().max()) <= 1e-13 * float(k.abs().max())
    # the boundary stays the unit-area rectangle
    assert float(area.sum()) == pytest.approx(1.0, rel=1e-13)
    assert float(_assembled(m, mass).sum()) == pytest.approx(1.0, rel=1e-13)
    # the cotangent form is the gradient form of P1 elements: grad of
    # vertex k's hat function is its opposite edge turned a right angle,
    # over twice the area, and a turn keeps dot products
    p = m.xy[m.tris]
    edges = torch.stack([p[:, (k + 1) % 3] - p[:, (k + 2) % 3]
                         for k in range(3)], 1)
    gram = edges @ edges.transpose(1, 2) / (4 * area)[:, None, None]
    assert torch.allclose(stiff, gram, rtol=0, atol=1e-12)


def test_operator_is_symmetric_positive_definite():
    m = _mesh(5)
    rows, cols, vals = mesh2d.triples(m)
    a = _dense(m.n, rows, cols, vals)
    assert torch.equal(a, a.T)
    lam = torch.linalg.eigvalsh(a)
    assert float(lam[0]) > 0
    # the constant mode: 1' A 1 / 1' 1 = area / n bounds the least eigenvalue
    assert float(lam[0]) <= 1.0 / m.n + 1e-15


def _tiny_state(seed=SEED):
    return SimpleNamespace(seed=seed, device=torch.device("cpu"),
                           config=dict(CONFIG, **TINY["config"]), gen=mesh2d)


def test_two_requests_give_different_patterns():
    st = _tiny_state()
    keys = []
    for i in range(4):
        n, rows, cols, vals, b = driver._inputs(st, i)
        coo = from_triples((n, n), rows, cols, vals)
        keys.append((n, coo.row.tolist(), coo.col.tolist()))
        assert 256 * 0.95 <= n <= 1024 * 1.05 and b.shape == (n,)
    assert len({json.dumps(k) for k in keys}) == len(keys)


def test_node_counts_are_drawn_per_request_and_log_uniform():
    # each request's share is uniform over the seeds, and over the
    # requests of one seed
    for shares in ([driver.size(SEED + k, 5) for k in range(4000)],
                   [driver.size(SEED, i) for i in range(-1, 3999)]):
        assert all(0.0 <= u < 1.0 for u in shares)
        for q in (0.1, 0.25, 0.5, 0.75, 0.9):
            assert abs(sum(u < q for u in shares) / len(shares) - q) < 0.03
    # drawn for each request alone: neighbours are uncorrelated, and a
    # request's share does not depend on the request before it
    u = torch.tensor([driver.size(SEED, i) for i in range(4000)],
                     dtype=torch.float64)
    assert abs(float(torch.corrcoef(torch.stack([u[:-1], u[1:]]))[0, 1])) \
        < 0.05
    assert abs(float(torch.corrcoef(torch.stack([u[0::2], 1 - u[1::2]]))[
        0, 1])) < 0.05
    assert driver.size(SEED, 7) == driver.size(SEED, 7)
    assert driver.size(SEED, 7) != driver.size(SEED + 1, 7)
    lo, hi = CONFIG["nodes"]
    assert mesh2d.log_share(lo, hi, 0.0) == pytest.approx(lo)
    assert mesh2d.log_share(lo, hi, 0.5) == pytest.approx(2 ** 17)


def test_triples_hold_duplicates_that_from_triples_sums():
    m = _mesh(6)
    rows, cols, vals = mesh2d.triples(m)
    coo = from_triples((m.n, m.n), rows, cols, vals)
    assert len(vals) == 9 * len(m.tris)
    # each interior edge twice, each diagonal once a triangle around it
    assert coo.nnz < len(vals) // 2
    got = _dense(m.n, coo.row.long(), coo.col.long(), coo.data)
    want = _dense(m.n, rows, cols, vals)
    assert torch.allclose(got, want, rtol=1e-15, atol=1e-15)
    csr = coo.tocsr()
    assert torch.allclose(csr.todense(), want, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("seed", [7, 8])
def test_staged_no_dims_path_matches_a_dense_solve(seed):
    m = _mesh(seed)
    rows, cols, vals = mesh2d.triples(m)
    b = torch.randn(m.n, dtype=torch.float64, generator=_gen(seed))
    mat = from_triples((m.n, m.n), rows, cols, vals).tocsr()
    sym = api.analyze(mat, backend="multifrontal")
    fac = api.factor(mat, sym, backend="multifrontal", kind="cholesky")
    x = api.solve(fac, b)
    assert not fac.breakdown
    want = torch.linalg.solve(_dense(m.n, rows, cols, vals), b)
    err = torch.linalg.vector_norm(x - want) / torch.linalg.vector_norm(want)
    assert float(err) <= 1e-12
    one_shot = api.linear_solve(mat, b, backend="multifrontal",
                                kind="cholesky")
    assert torch.equal(one_shot, x)


def _grid_operator():
    from sparse_linear_tpu_torch.utils.grids import poisson_2d

    return poisson_2d(20, dtype=torch.float64, device="cpu")


def _mesh_operator():
    m = _mesh(9)
    return from_triples((m.n, m.n), *mesh2d.triples(m)).tocsr()


@pytest.mark.parametrize("make,opts", [
    (_mesh_operator, {}), (_mesh_operator, {"ordering": "nd"}),
    (_mesh_operator, {"ordering": "rcm"}),
    (_grid_operator, {"dims": (20, 20)})],
    ids=["auto (AMD)", "general-graph ND", "RCM", "grid ND"])
def test_analyze_keeps_a_record_of_its_stages(make, opts):
    sym = mf.analyze(make(), **opts)
    rec = sym.stats
    assert set(rec) == set(STAGES) | {"supernodes", "buckets", "levels"}
    assert all(isinstance(rec[k], float) and rec[k] >= 0 for k in STAGES)
    sched = sym.schedule
    assert rec["supernodes"] == sched["nsuper"]
    assert rec["buckets"] == len(sched["flat"])
    assert rec["levels"] == len(sched["level_buckets"]) == sched["height"] + 1
    assert rec["supernodes"] == sum(len(b["sup_ids"]) for b in sched["flat"])


def test_a_symbolic_built_without_analyze_has_an_empty_record():
    m = _mesh(10)
    mat = from_triples((m.n, m.n), *mesh2d.triples(m)).tocsr()
    sym = mf.analyze(mat)
    other = mf.MFSymbolic(sym.n, sym.perm, sym.schedule, sym.pattern_key,
                          sym.a_entry_maps)
    assert other.stats == {} and sym.stats != {}


def _run(trace=False, seconds=0.6, **kw):
    return harness.run_cell(ROOT, CELL, SEED, seconds, trace, device="cpu",
                            overrides=TINY, log=lambda s: None, **kw)


def test_cell_runs_and_is_correct_on_the_cpu():
    res = _run()
    assert res["correct"] and res["attempted"] >= 2 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "refactor_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == {"resid"}
    assert res["checks"]["resid"]["value"] <= 1e-12


def test_traced_cell_reports_the_new_pattern_metrics():
    res = _run(trace=True)
    assert res["correct"]
    got = res["metrics"]
    # on the CPU the device trace holds no device time: no idle share
    assert set(got) == {"analyze_s.request", "analyze.order_s",
                        "analyze.maps_s", "analyze.symmetrize_s",
                        "direct.factor_s", "assembly_ms"}
    assert got["analyze.order_s"]["value"] < got["analyze_s.request"][
        "value"]
    assert got["analyze.maps_s"]["value"] < got["analyze_s.request"]["value"]
    assert got["analyze.symmetrize_s"]["value"] < got["analyze_s.request"][
        "value"]


def test_every_request_is_a_new_pattern_analysed_without_dims(monkeypatch):
    calls = []
    real = api.analyze

    def analyze(mat, backend="dense", **opts):
        calls.append((backend, opts, mat.shape[0], mf._pattern_key(mat)))
        return real(mat, backend=backend, **opts)

    monkeypatch.setattr(api, "analyze", analyze)
    res = _run()
    assert res["correct"] and len(calls) == res["attempted"] + 1  # warm-up
    assert all(c[:2] == ("multifrontal", {}) for c in calls)
    patterns = [c[2:] for c in calls]
    assert len(set(patterns)) == len(patterns)


def test_cell_control_comes_out_not_correct():
    res = _run(control=True)
    assert not res["correct"]
    assert res["checks"]["resid"]["value"] > 1e3 * 1e-10


def _answer_altered(monkeypatch):
    real = api.solve

    def altered(fac, b, **kw):
        x = real(fac, b, **kw)
        x[0] *= 1 + 1e-6
        return x

    monkeypatch.setattr(api, "solve", altered)


def _previous_answer(monkeypatch):
    real, held = api.solve, []

    def previous(fac, b, **kw):
        held.append(real(fac, b, **kw))
        return held[-2] if len(held) > 1 else held[-1]

    monkeypatch.setattr(api, "solve", previous)


FAULTS = [("an answer altered", _answer_altered),
          ("the previous request's x returned", _previous_answer)]


@pytest.mark.parametrize("plant", [p for _, p in FAULTS],
                         ids=[f for f, _ in FAULTS])
def test_a_fault_in_the_timed_path_is_caught(plant, monkeypatch):
    plant(monkeypatch)
    assert not _run()["correct"]


def _ctx(device="cpu", config=None, seed=SEED):
    return SimpleNamespace(config=config or dict(CONFIG, **TINY["config"]),
                           workload=WORKLOAD, seed=seed,
                           device=torch.device(device),
                           run=harness.Run(torch.device(device)),
                           dtype=torch.float64, log=lambda s: None)


def test_serve_reads_a_cholesky_breakdown():
    st = driver.setup(_ctx())
    driver.prepare(st, 0)
    assert driver.serve(st, 0)
    driver.prepare(st, 1)
    st.vals = -st.vals  # negative definite: the first front breaks down
    assert not driver.serve(st, 1)


def test_inputs_are_drawn_from_the_seed_and_the_request_alone():
    st = _tiny_state()
    a, b = driver._inputs(st, 3), driver._inputs(st, 3)
    c = driver._inputs(st, 4)
    assert all(torch.equal(u, v) for u, v in zip(a[1:], b[1:]))
    assert a[0] == b[0] and not (a[0] == c[0] and torch.equal(a[3], c[3]))
    st.seed = SEED + 1
    d = driver._inputs(st, 3)
    assert not (a[0] == d[0] and torch.equal(a[3], d[3]))


# ---------------------------------------------------------------------------
# on the card, at 2^16 nodes
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cell's requests at 2^16 nodes "
                    "run on the card)")
    from sparse_linear_tpu_torch.kernels import _build

    torch.cuda.set_device(0)
    _build.load_library()
    return torch.device("cuda", 0)


def _card_state(card):
    cfg = dict(CONFIG, nodes=[2 ** 16, 2 ** 16])
    return driver.setup(_ctx(card, config=cfg))


@pytest.mark.cuda
def test_device_memory_returns_to_its_level_after_each_request(card):
    st = _card_state(card)  # the warm-up request ran in set-up
    torch.cuda.synchronize(card)
    level = torch.cuda.memory_allocated(card)
    for i in range(3):
        driver.prepare(st, i)
        assert driver.serve(st, i)
        torch.cuda.synchronize(card)
        assert torch.cuda.memory_allocated(card) == level
    assert st.levels == [level] * 3
    assert driver.check(st)["resid"] <= 1e-10


@pytest.mark.cuda
def test_new_pattern_requests_capture_no_graph(card):
    st = _card_state(card)
    before = mf.replay_counts()
    for i in range(3):
        driver.prepare(st, i)
        assert driver.serve(st, i)
    after = mf.replay_counts()
    assert after == before
    assert math.isfinite(driver.check(st)["resid"])
