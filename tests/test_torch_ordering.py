"""Orderings and symbolic analysis of the port against the JAX package.

The fill-reducing orderings (natural, RCM, geometric and general nested
dissection, AMD) and the symbolic engine are host code in both packages:
the port keeps its own copy of the numpy functions and of the C++ sources,
which it builds itself (``sparse_linear_tpu_torch/utils/native.py``).  The
same pattern must give exactly the same permutation and exactly the same
supernode forest.  The port's plain Python engine (``solve/symbolic_py``)
is held to its native one the same way.
"""

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
)
from sparse_linear_tpu_torch.utils import native as pnative  # noqa: E402
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
