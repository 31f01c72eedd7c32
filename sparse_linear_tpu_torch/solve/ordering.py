"""Fill-reducing orderings for the direct solver.

Counterpart of :mod:`sparse_linear_tpu.solve.ordering`, numpy on the host;
AMD and general-graph ND run in the port's own host library
(``utils/native.py``), which raises where the JAX package falls back.

The capability the reference obtains from UMFPACK's internal COLAMD/AMD
ordering (hidden behind umfpack_*_symbolic, reference:
suitesparse/src/Numeric/LinearAlgebra/Umfpack/Internal.hs:137-138).  Provided
natively:

* ``nested_dissection_grid`` — geometric recursive bisection for regular
  1D/2D/3D grid problems (the benchmark family): O(n^1.5) 2D fill, the
  right ordering for batched dense fronts, since separator fronts are large
  dense blocks.
* ``rcm`` — reverse Cuthill-McKee for general symmetric patterns (banded
  fronts; robust default when no geometry is known).
* ``natural`` — identity.

All return a permutation array ``perm`` such that the reordered matrix is
A[perm, :][:, perm].
"""

from __future__ import annotations

import numpy as np

__all__ = ["natural", "rcm", "amd", "nested_dissection_grid",
           "nested_dissection", "ordering_by_name"]


def natural(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.int32)


def rcm(indptr, indices, n: int) -> np.ndarray:
    """Reverse Cuthill-McKee on the (assumed symmetric) pattern."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    degree = np.diff(indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int32)
    pos = 0
    # component loop
    remaining = np.argsort(degree, kind="stable")
    rem_idx = 0
    while pos < n:
        while rem_idx < n and visited[remaining[rem_idx]]:
            rem_idx += 1
        start = remaining[rem_idx]
        # pseudo-peripheral: double BFS
        for _ in range(2):
            frontier = np.array([start])
            visited_bfs = np.zeros(n, dtype=bool)
            visited_bfs[start] = True
            last = start
            while frontier.size:
                nbrs = indices[
                    np.concatenate(
                        [np.arange(indptr[u], indptr[u + 1]) for u in frontier]
                    )
                ] if frontier.size else np.empty(0, np.int32)
                nbrs = np.unique(nbrs)
                nbrs = nbrs[~visited_bfs[nbrs]]
                if nbrs.size == 0:
                    break
                visited_bfs[nbrs] = True
                last = nbrs[np.argmin(degree[nbrs])]
                frontier = nbrs
            start = last
        # CM BFS from start
        queue = [start]
        visited[start] = True
        qi = 0
        comp_start = pos
        order[pos] = start
        pos += 1
        while qi < pos - comp_start:
            u = order[comp_start + qi]
            qi += 1
            nb = indices[indptr[u]: indptr[u + 1]]
            nb = nb[~visited[nb]]
            if nb.size:
                nb = np.unique(nb)
                nb = nb[np.argsort(degree[nb], kind="stable")]
                visited[nb] = True
                order[pos: pos + nb.size] = nb
                pos += nb.size
    return order[::-1].copy().astype(np.int32)


def amd(indptr, indices, n: int) -> np.ndarray:
    """Approximate minimum degree (native C++ quotient-graph engine,
    csrc/host/ordering.cpp — the ordering family UMFPACK uses internally).
    Raises ``RuntimeError`` when the host library cannot be built."""
    from sparse_linear_tpu_torch.utils.native import native_amd

    return native_amd(n, indptr, indices)


def nested_dissection_grid(dims, leaf: int = 64) -> np.ndarray:
    """Geometric nested dissection for a regular grid with the given dims
    (row-major index = x + nx*(y + ny*z)).  Separator planes are eliminated
    last; recursion stops at ``leaf``-sized blocks (natural order inside).
    """
    dims = tuple(int(d) for d in dims)
    nd = len(dims)
    if nd == 1:
        nx, ny, nz = dims[0], 1, 1
    elif nd == 2:
        nx, ny = dims
        nz = 1
    elif nd == 3:
        nx, ny, nz = dims
    else:
        raise ValueError("dims must have 1-3 entries")
    n = nx * ny * nz
    # coordinates of every node
    idx = np.arange(n, dtype=np.int64)
    coords = np.stack(
        [idx % nx, (idx // nx) % ny, idx // (nx * ny)], axis=1
    )

    out = np.empty(n, dtype=np.int32)
    cursor = 0

    # iterative recursion with an explicit stack of (node-index-array) jobs;
    # children pushed before the separator so separators land last
    def emit(block):
        nonlocal cursor
        out[cursor: cursor + block.size] = block
        cursor += block.size

    def process(block):
        if block.size <= leaf:
            return [("emit", block)]
        c = coords[block]
        spans = c.max(axis=0) - c.min(axis=0) + 1
        ax = int(np.argmax(spans))
        lo = c[:, ax].min()
        mid = lo + spans[ax] // 2
        left = block[c[:, ax] < mid]
        sep = block[c[:, ax] == mid]
        right = block[c[:, ax] > mid]
        return [("recurse", left), ("recurse", right), ("emit", sep)]

    # depth-first with an explicit op stack; post-order (left, right,
    # then separator) so separators are eliminated last
    opstack = [("recurse", idx.astype(np.int32))]
    order_ops = []
    while opstack:
        op, block = opstack.pop()
        if op == "emit":
            order_ops.append(block)
            continue
        if block.size <= leaf:
            order_ops.append(block)
            continue
        steps = process(block)
        # push in reverse so left is handled first
        for s in reversed(steps):
            opstack.append(s)

    for block in order_ops:
        emit(block)
    assert cursor == n
    return out


def nested_dissection(indptr, indices, n: int, leaf: int = 64) -> np.ndarray:
    """General-graph nested dissection (native C++ George-Liu level-set
    bisection with AMD-ordered leaves, csrc/host/ordering.cpp) for
    unstructured symmetric patterns — the ordering family UMFPACK/CHOLMOD
    reach through METIS.  Raises ``RuntimeError`` when the host library
    cannot be built."""
    from sparse_linear_tpu_torch.utils.native import native_nd

    return native_nd(n, indptr, indices, leaf=leaf)


def ordering_by_name(name: str, indptr, indices, n: int, dims=None):
    if name == "natural":
        return natural(n)
    if name == "rcm":
        return rcm(indptr, indices, n)
    if name == "amd":
        return amd(indptr, indices, n)
    if name in ("nd", "nested-dissection"):
        if dims is None:
            return nested_dissection(indptr, indices, n)
        return nested_dissection_grid(dims)
    raise ValueError(f"unknown ordering: {name}")
