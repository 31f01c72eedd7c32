"""Each cell driven whole at a tiny size through the harness's internal
entry on the CPU: the result line, a cell added by files alone, the
control and the faults that ``correct`` has to catch, the import check,
and the command's refusal without a card.
CPU only:  python -m pytest spbench -q"""

import ast
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spbench import harness

ROOT = Path(__file__).resolve().parent.parent
SECONDS = {"direct-refactor": 2.5}  # 20 requests or more for its p95
TINY = {
    "feast-slices": {"config": {"grid": [16, 16]},
                     "workload": {"m0": 16, "per_window": 8, "slack": 2,
                                  "windows": 30, "trace_seconds": 0.2}},
    "cg-grid": {"config": {"grid": [8, 8, 8]},
                "workload": {"trace_seconds": 0.05}},
    "cg-shuffled": {"config": {"grid": [8, 8, 8]},
                    "workload": {"trace_seconds": 0.05}},
    "direct-refactor": {"config": {"grid": [16, 16]},
                        "workload": {"trace_seconds": 0.1}},
}
SEED = 2 ** 31 + 12345
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tiny cells are launch-bound, and several
    test workers share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _run(cell, trace=False, seed=SEED, root=ROOT, overrides=None, **kw):
    return harness.run_cell(root, cell, seed, SECONDS.get(cell, 0.3), trace,
                            device="cpu",
                            overrides=overrides or TINY[cell],
                            log=lambda s: None, **kw)


def _spec(kind, cell):
    return {m["name"]: m["unit"] for m in BENCH[kind]
            if cell in m.get("workloads", [cell])}


def test_every_cell_has_a_tiny_size():
    assert set(TINY) == {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_and_is_correct(cell):
    res = _run(cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "setup_stages", "built", "card",
                         "checks"]
    assert res["built"] == [] and "kernel_library" not in res["setup_stages"]
    assert res["correct"] and res["attempted"] >= 1 and res["failed"] == 0
    assert {k: v["unit"] for k, v in res["metrics"].items()} == _spec(
        "end_to_end", cell)
    assert all(v["value"] > 0 for v in res["metrics"].values())
    limits = json.loads(
        (ROOT / "spbench" / "workloads" / f"{cell}.json").read_text())[
            "limits"]
    assert set(res["checks"]) == set(limits)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_traced_run_reports_host_side_layers(cell):
    res = _run(cell, trace=True)
    assert res["correct"]
    want = _spec("per_layer", cell)
    got = res["metrics"]
    # on the CPU the readers of the device trace find nothing to read
    device_only = {k for k in want if "roofline" in k or "idle" in k
                   or "peak" in k}
    assert set(got) == set(want) - device_only
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_inputs_are_drawn_from_the_seed_and_the_request_alone():
    from types import SimpleNamespace

    from spbench.drivers import cg, direct_refactor, feast_slices
    from spbench.operators import laplacian
    from spbench.reference import spectrum

    def st(seed, **kw):
        return SimpleNamespace(seed=seed, device="cpu", grid=[6, 5], n=30,
                               gen=laplacian, perm=None, sigma=1.0, corr=0.3,
                               **kw)

    for draw in (cg._rhs, lambda s, i: direct_refactor._inputs(s, i)[0]):
        a, b, c = draw(st(SEED), 4), draw(st(SEED), 4), draw(st(SEED), 5)
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert not torch.equal(a, draw(st(SEED + 1), 4))
    lam = spectrum.eigenvalues([16, 16])
    # below the middle of the spectrum, where no cluster is wider than
    # the slack (16**2 holds 4.0 sixteen times)
    edges = feast_slices.slice_edges(lam, 8, 2, 12)
    assert edges == feast_slices.slice_edges(lam, 8, 2, 12)
    counts = [len(spectrum.inside(lam, w)) for w in zip(edges, edges[1:])]
    assert all(abs(c - 8) <= 2 * 2 for c in counts)
    for e in edges:  # no edge splits a double eigenvalue
        assert np.abs(lam - e).min() > 1e-6


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_comes_out_not_correct(cell):
    res = _run(cell, control=True)
    assert not res["correct"]


def _cg_unchanged(monkeypatch):
    from sparse_linear_tpu_torch.solve import cg as mod

    monkeypatch.setattr(mod, "cg", lambda mv, b, **kw: mod.CgResult(
        torch.zeros_like(b), 0, torch.linalg.vector_norm(b), True))


def _cg_altered(monkeypatch):
    from sparse_linear_tpu_torch.solve import cg as mod

    real = mod.cg

    def altered(mv, b, **kw):
        res = real(mv, b, **kw)
        res.x[len(b) // 2] += 1e-6 * float(res.x.abs().max())
        return res

    monkeypatch.setattr(mod, "cg", altered)


def _direct_stale(monkeypatch):
    from sparse_linear_tpu_torch.solve import api

    real, first = api.factor, []

    def stale(*args, **kw):
        if not first:
            first.append(real(*args, **kw))
        return first[0]

    monkeypatch.setattr(api, "factor", stale)


def _direct_altered(monkeypatch):
    from sparse_linear_tpu_torch.solve import api

    real = api.solve

    def altered(fac, b, **kw):
        x = real(fac, b, **kw)
        x[0] *= 1 + 1e-6
        return x

    monkeypatch.setattr(api, "solve", altered)


def _feast_wrapped(monkeypatch, change):
    from sparse_linear_tpu_torch.eig import feast

    real = feast.eigsh

    def wrapped(m0, interval, a, params, **kw):
        return change(real(m0, interval, a, params, **kw))

    monkeypatch.setattr(feast, "eigsh", wrapped)


def _feast_half(monkeypatch):
    _feast_wrapped(monkeypatch, lambda r: r._replace(
        values=r.values[::2], vectors=r.vectors[:, ::2],
        n_found=len(r.values[::2])))


def _feast_altered(monkeypatch):
    def change(r):
        values = r.values.copy()
        values[0] += 1e-6
        return r._replace(values=values)

    _feast_wrapped(monkeypatch, change)


def _feast_duplicated(monkeypatch):
    """The last pair lost, the first returned in its place."""
    def change(r):
        values, vectors = r.values.copy(), r.vectors.clone()
        values[-1], vectors[:, -1] = values[0], vectors[:, 0]
        return r._replace(values=values, vectors=vectors)

    _feast_wrapped(monkeypatch, change)


def _feast_twin_vector(monkeypatch):
    """Within a double eigenvalue, one vector returned for both pairs."""
    def change(r):
        vectors = r.vectors.clone()
        j = int(np.argmin(np.diff(r.values)))  # the closest two values
        vectors[:, j + 1] = vectors[:, j]
        return r._replace(vectors=vectors)

    _feast_wrapped(monkeypatch, change)


def _feast_unchanged(monkeypatch):
    held = []

    def change(r):
        held.append(r)
        return held[0]

    _feast_wrapped(monkeypatch, change)


FAULTS = [
    ("cg-grid", "state unchanged", _cg_unchanged),
    ("cg-grid", "answer altered", _cg_altered),
    ("cg-shuffled", "state unchanged", _cg_unchanged),
    ("cg-shuffled", "answer altered", _cg_altered),
    ("direct-refactor", "state unchanged", _direct_stale),
    ("direct-refactor", "answer altered", _direct_altered),
    ("feast-slices", "state unchanged", _feast_unchanged),
    ("feast-slices", "half the batch left out", _feast_half),
    ("feast-slices", "answer altered", _feast_altered),
    ("feast-slices", "a pair lost, another duplicated", _feast_duplicated),
    ("feast-slices", "a vector duplicated in a double eigenvalue",
     _feast_twin_vector),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS,
                         ids=[f"{c}: {f}" for c, f, _ in FAULTS])
def test_a_fault_in_the_timed_path_is_caught(cell, fault, plant,
                                             monkeypatch):
    plant(monkeypatch)
    assert not _run(cell)["correct"]


def test_a_cell_added_as_files_alone_runs(tmp_path):
    shutil.copytree(ROOT / "spbench", tmp_path / "spbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "poisson2d-tiny-f64", "source": "a test", "reduced": [],
        "file": "spbench/configs/poisson2d-tiny-f64.json", "why": "a test"})
    bench["workloads"].append({
        "name": "cg-tiny", "config": "poisson2d-tiny-f64",
        "traffic": "rhs-tiny", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "cg-grid" in m.get("workloads", []):
            m["workloads"].append("cg-tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cfg = json.loads(
        (ROOT / "spbench" / "configs" / "poisson2d-1m-f64.json").read_text())
    cfg.update(name="poisson2d-tiny-f64", grid=[20, 10], n=200)
    (tmp_path / "spbench" / "configs" / "poisson2d-tiny-f64.json").write_text(
        json.dumps(cfg))
    wl = json.loads(
        (ROOT / "spbench" / "workloads" / "cg-grid.json").read_text())
    wl.update(name="cg-tiny", config="poisson2d-tiny-f64", why="a test")
    (tmp_path / "spbench" / "workloads" / "cg-tiny.json").write_text(
        json.dumps(wl))
    res = harness.run_cell(tmp_path, "cg-tiny", SEED, 0.2, False,
                           device="cpu", log=lambda s: None)
    assert res["correct"] and set(res["metrics"]) == {"setup_s", "solve_s"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_nothing_imports_jax_or_the_jax_package():
    for path in (ROOT / "spbench").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (ROOT / "spbench" / "reference").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert tops <= {"__future__", "math", "numpy", "torch"}, path


def test_forbidden_modules_compares_whole_top_level_names():
    mods = ["sparse_linear_tpu_torch", "sparse_linear_tpu_torch.eig",
            "jaxtyping", "jax_fake_ok", "numpy"]
    assert harness.forbidden_modules(mods) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla", "flax", "sparse_linear_tpu",
           "sparse_linear_tpu.eig"]
    assert harness.forbidden_modules(mods + bad) == sorted(bad)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    # in a fresh process, as the command runs: the port and the harness
    import subprocess

    code = ("import sys; sys.path.insert(0, %r); "
            "from spbench import harness; import sparse_linear_tpu_torch; "
            "from sparse_linear_tpu_torch.eig import feast, pipeline; "
            "from sparse_linear_tpu_torch.solve import api, cg; "
            "import spbench.drivers.cg, spbench.drivers.feast_slices, "
            "spbench.drivers.direct_refactor; "
            "print(harness.forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_the_command_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = harness.main(["--workload", "cg-grid", "--seed", "1", "--seconds",
                       "1"], 0.0, ROOT)
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err
