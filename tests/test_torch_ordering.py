"""Orderings and symbolic analysis of the port against the JAX package.

The fill-reducing orderings (natural, RCM, geometric and general nested
dissection, AMD) and the symbolic engine are host code in both packages:
the port keeps its own copy of the numpy functions and of the C++ sources,
which it builds itself (``sparse_linear_tpu_torch/utils/native.py``).  The
same pattern must give exactly the same permutation and exactly the same
supernode forest.  The port's plain Python engine (``solve/symbolic_py``)
is held to its native one the same way, and the port's native pattern of
P (A + A^T + I) P^T to the JAX package's numpy one, bit for bit.
"""

import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_linear_tpu.solve import ordering as jord  # noqa: E402
from sparse_linear_tpu.solve.multifrontal import (  # noqa: E402
    _symmetrized_pattern as j_sym_pattern,
)
from sparse_linear_tpu.utils import native as jnative  # noqa: E402
from sparse_linear_tpu.utils.grids import poisson_2d  # noqa: E402
from sparse_linear_tpu_torch.solve import ordering as pord  # noqa: E402
from sparse_linear_tpu_torch.solve.symbolic_py import (  # noqa: E402
    python_symbolic,
    python_symmetrize,
)
from sparse_linear_tpu_torch.utils import native as pnative  # noqa: E402
from spbench.operators import mesh2d  # noqa: E402
from tests.torch_parity import permuted_poisson  # noqa: E402


def _path_graph(nn):
    ip = np.zeros(nn + 1, np.int64)
    ix = []
    for i in range(nn):
        ix += [j for j in (i - 1, i + 1) if 0 <= j < nn]
        ip[i + 1] = len(ix)
    return ip, np.asarray(ix, np.int32), nn


def _star_graph(nn):
    rows = np.concatenate([np.zeros(nn - 1, np.int64), np.arange(1, nn)])
    cols = np.concatenate([np.arange(1, nn), np.zeros(nn - 1, np.int64)])
    order = np.lexsort((cols, rows))
    ip = np.zeros(nn + 1, np.int64)
    np.add.at(ip, rows + 1, 1)
    return np.cumsum(ip), cols[order].astype(np.int32), nn


def _pattern(m):
    """Symmetrized pattern (A + A^T + I) of a JAX-package matrix."""
    ip, ix = j_sym_pattern(m, np.arange(m.shape[0], dtype=np.int32))
    return ip, ix, m.shape[0]


GRAPHS = {
    "poisson_12": lambda: _pattern(poisson_2d(12, dtype=np.float64)),
    "shuffled_poisson_16": lambda: _pattern(permuted_poisson(16, np.float64)),
    "path_200": lambda: _path_graph(200),
    "no_edges_30": lambda: (np.zeros(31, np.int64), np.zeros(0, np.int32),
                            30),
    "star_40": lambda: _star_graph(40),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("name", ["rcm", "amd", "nested_dissection"])
def test_graph_orderings_equal_jax(name, graph):
    ip, ix, n = GRAPHS[graph]()
    got = getattr(pord, name)(ip, ix, n)
    want = getattr(jord, name)(ip, ix, n)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))


@pytest.mark.parametrize("dims", [(50,), (12, 12), (7, 5), (6, 6, 6),
                                  (9, 4, 3)])
def test_nested_dissection_grid_equal_jax(dims):
    for leaf in (8, 64):
        np.testing.assert_array_equal(
            pord.nested_dissection_grid(dims, leaf=leaf),
            jord.nested_dissection_grid(dims, leaf=leaf))


def test_natural_and_by_name_equal_jax():
    ip, ix, n = GRAPHS["shuffled_poisson_16"]()
    np.testing.assert_array_equal(pord.natural(n), jord.natural(n))
    for name, dims in [("natural", None), ("rcm", None), ("amd", None),
                       ("nd", None), ("nd", (16, 16)),
                       ("nested-dissection", None)]:
        np.testing.assert_array_equal(
            pord.ordering_by_name(name, ip, ix, n, dims=dims),
            jord.ordering_by_name(name, ip, ix, n, dims=dims))
    with pytest.raises(ValueError, match="unknown ordering"):
        pord.ordering_by_name("colamd", ip, ix, n)


def _permuted_pattern(graph, order):
    """Symmetrized pattern of a graph relabelled by ``order``."""
    ip, ix, n = GRAPHS[graph]()
    perm = {"natural": lambda: np.arange(n),
            "amd": lambda: jord.amd(ip, ix, n),
            "nd": lambda: jord.nested_dissection(ip, ix, n)}[order]()
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    rows = np.repeat(np.arange(n), np.diff(ip))
    key = np.unique(np.concatenate([
        iperm[rows] * n + iperm[ix], iperm[ix] * n + iperm[rows],
        np.arange(n) * (n + 1)]))
    r, c = key // n, key % n
    out = np.zeros(n + 1, np.int32)
    np.add.at(out, r + 1, 1)
    return np.cumsum(out).astype(np.int32), c.astype(np.int32), n


SYMBOLIC_CASES = [("poisson_12", "natural"), ("poisson_12", "nd"),
                  ("shuffled_poisson_16", "amd"), ("path_200", "natural"),
                  ("star_40", "amd"), ("no_edges_30", "natural")]


@pytest.mark.parametrize("relax", [(16, 0.25), (4, 0.0), (64, 0.6)])
@pytest.mark.parametrize("graph,order", SYMBOLIC_CASES)
def test_native_symbolic_equal_jax(graph, order, relax):
    ip, ix, n = _permuted_pattern(graph, order)
    got = pnative.native_symbolic(n, ip, ix, *relax)
    want = jnative.native_symbolic(n, ip, ix, *relax)
    assert want is not None
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("graph,order", SYMBOLIC_CASES)
def test_python_symbolic_equal_native(graph, order):
    ip, ix, n = _permuted_pattern(graph, order)
    got = python_symbolic(n, ip, ix, 16, 0.25)
    want = pnative.native_symbolic(n, ip, ix, 16, 0.25)
    for k in ("nsuper", "sup_start", "sup_parent", "sup_level", "rows_ptr",
              "rows", "lnnz", "height", "max_front", "max_pivots"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_host_library_is_keyed_by_hash():
    path = pnative.library_path()
    assert path.parent.name == "_build"
    assert path.name.startswith("libslt_host_") and path.suffix == ".so"
    pnative.load()
    assert path.is_file()
    assert [p.name for p in pnative.sources()] == ["ordering.cpp",
                                                   "symbolic.cpp"]


def _csr_of(n, rows, cols, sort_cols=True):
    """CSR pattern of (rows, cols): rows in order, each row's columns
    sorted and unique, or with ``sort_cols=False`` left as given, repeats
    and all."""
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    if sort_cols:
        key = np.unique(rows * n + cols)
        rows, cols = key // n, key % n
    else:
        order = np.argsort(rows, kind="stable")
        rows, cols = rows[order], cols[order]
    ip = np.zeros(n + 1, np.int64)
    np.add.at(ip, rows + 1, 1)
    return np.cumsum(ip), cols.astype(np.int32), n


def _upper_triangular(n=60, seed=4):
    rng = np.random.default_rng(seed)
    r, c = np.triu_indices(n, k=1)
    keep = rng.random(r.size) < 0.1
    return _csr_of(n, r[keep], c[keep])


def _empty_rows(n=40, seed=5):
    """Half the rows hold nothing; the entries land anywhere."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(np.arange(0, n, 2), 70)
    return _csr_of(n, rows, rng.integers(0, n, 70))


def _mesh_triples(sort_cols):
    """The pattern of a small ``fem2d-newmesh-f64`` mesh's triples."""
    cfg = json.loads((Path(__file__).resolve().parent.parent / "spbench"
                      / "configs" / "fem2d-newmesh-f64.json").read_text())
    m = mesh2d.mesh(600, cfg["aspect"], cfg["jitter"],
                    torch.Generator().manual_seed(11), "cpu")
    rows, cols, _ = mesh2d.triples(m)
    return _csr_of(m.n, rows.numpy(), cols.numpy(), sort_cols)


SYM_GRAPHS = {
    **GRAPHS,
    "upper_triangular_60": _upper_triangular,
    "empty_rows_40": _empty_rows,
    "one_node": lambda: (np.zeros(2, np.int64), np.zeros(0, np.int32), 1),
    "one_node_diagonal": lambda: (np.array([0, 1], np.int64),
                                  np.zeros(1, np.int32), 1),
    "mesh": lambda: _mesh_triples(True),
    "mesh_repeats_unsorted": lambda: _mesh_triples(False),
}


def _perm_of(kind, ip, ix, n):
    if kind == "identity":
        return np.arange(n, dtype=np.int32)
    if kind == "random":
        return np.random.default_rng(n).permutation(n).astype(np.int32)
    sp_ip, sp_ix = j_sym_pattern(SimpleNamespace(shape=(n, n), indptr=ip,
                                                 indices=ix),
                                 np.arange(n, dtype=np.int32))
    return jord.amd(sp_ip, sp_ix, n)


@pytest.mark.parametrize("perm_kind", ["identity", "random", "amd"])
@pytest.mark.parametrize("graph", sorted(SYM_GRAPHS))
def test_native_symmetrize_equal_jax(graph, perm_kind):
    ip, ix, n = SYM_GRAPHS[graph]()
    perm = _perm_of(perm_kind, ip, ix, n)
    got_ip, got_ix = pnative.native_symmetrize(n, ip, ix, perm)
    want_ip, want_ix = j_sym_pattern(
        SimpleNamespace(shape=(n, n), indptr=ip, indices=ix), perm)
    assert got_ip.dtype == np.int64 and got_ix.dtype == np.int32
    np.testing.assert_array_equal(got_ip, want_ip)
    np.testing.assert_array_equal(got_ix, want_ix)


@pytest.mark.parametrize("graph", sorted(SYM_GRAPHS))
def test_python_symmetrize_equal_native(graph):
    ip, ix, n = SYM_GRAPHS[graph]()
    perm = _perm_of("random", ip, ix, n)
    got_ip, got_ix = python_symmetrize(n, ip, ix, perm)
    want_ip, want_ix = pnative.native_symmetrize(n, ip, ix, perm)
    assert got_ip.dtype == np.int64 and got_ix.dtype == np.int32
    np.testing.assert_array_equal(got_ip, want_ip)
    np.testing.assert_array_equal(got_ix, want_ix)


def test_native_symmetrize_rejects_bad_input():
    ip, ix, n = GRAPHS["path_200"]()
    perm = np.arange(n, dtype=np.int32)
    perm[3] = 4
    with pytest.raises(ValueError, match="not a permutation"):
        pnative.native_symmetrize(n, ip, ix, perm)
    bad = ix.copy()
    bad[5] = n
    with pytest.raises(ValueError, match="outside"):
        pnative.native_symmetrize(n, ip, bad, np.arange(n))
    with pytest.raises(ValueError, match="shape"):
        pnative.native_symmetrize(n, ip, ix, np.arange(n - 1))
    with pytest.raises(ValueError, match="rise from 0"):
        pnative.native_symmetrize(n, ip, ix[:-1], np.arange(n))
    falls = ip.copy()
    falls[7] = falls[9]
    with pytest.raises(ValueError, match="rise from 0"):
        pnative.native_symmetrize(n, falls, ix, np.arange(n))
