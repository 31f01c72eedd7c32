"""The plain Python version of the native symbolic analysis and of the
symmetrized pattern it reads.

``python_symbolic`` is a copy of :mod:`sparse_linear_tpu.solve.symbolic_py`,
with the contract of ``utils.native.native_symbolic``; ``python_symmetrize``
has the contract of ``utils.native.native_symmetrize``.  Correct but
unvectorized: they run only when asked for
(``multifrontal.analyze(..., engine="python")``), and the tests hold the
native engine to their output."""

from __future__ import annotations

import numpy as np

__all__ = ["python_symbolic", "python_symmetrize"]


def python_symmetrize(n, indptr, indices, perm):
    """The pattern of P (A + A^T + I) P^T as canonical CSR ``(indptr int64,
    indices int32)``, P sending node ``perm[k]`` to ``k``."""
    iperm = [0] * n
    for k, v in enumerate(perm):
        iperm[int(v)] = k
    rows = [{r} for r in range(n)]
    for i in range(n):
        for p in range(int(indptr[i]), int(indptr[i + 1])):
            r, c = iperm[i], iperm[int(indices[p])]
            rows[r].add(c)
            rows[c].add(r)
    out_indptr = np.zeros(n + 1, dtype=np.int64)
    out_indptr[1:] = np.cumsum([len(row) for row in rows])
    out_indices = np.array([c for row in rows for c in sorted(row)],
                           dtype=np.int32)
    return out_indptr, out_indices


def python_symbolic(n, indptr, indices, relax_small=16, relax_frac=0.25):
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)

    # elimination tree (path-compressed)
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    for j in range(n):
        for p in range(indptr[j], indptr[j + 1]):
            i = int(indices[p])
            if i >= j:
                continue
            while i != -1 and i < j:
                nxt = int(ancestor[i])
                ancestor[i] = j
                if nxt == -1:
                    parent[i] = j
                    break
                i = nxt

    # postorder
    children = [[] for _ in range(n)]
    roots = []
    for j in range(n):
        if parent[j] == -1:
            roots.append(j)
        else:
            children[parent[j]].append(j)
    post = []
    for r in roots:
        stack = [(r, iter(children[r]))]
        while stack:
            node, it = stack[-1]
            nxt = next(it, None)
            if nxt is None:
                post.append(node)
                stack.pop()
            else:
                stack.append((nxt, iter(children[nxt])))

    # per-column structures bottom-up
    st = [None] * n
    for j in post:
        s = set(int(i) for i in indices[indptr[j]: indptr[j + 1]] if i > j)
        for c in children[j]:
            s.update(r for r in st[c] if r > j)
        st[j] = sorted(s)

    # fundamental supernodes
    starts = [0]
    for j in range(1, n):
        if not (parent[j - 1] == j and len(st[j]) == len(st[j - 1]) - 1):
            starts.append(j)
    starts.append(n)
    ns0 = len(starts) - 1
    sup_of = np.empty(n, dtype=np.int64)
    for s in range(ns0):
        sup_of[starts[s]: starts[s + 1]] = s
    sparent = [
        -1 if parent[starts[s + 1] - 1] == -1 else int(sup_of[parent[starts[s + 1] - 1]])
        for s in range(ns0)
    ]

    # relaxed amalgamation (mirror of the native rule)
    merge_into = list(range(ns0))
    ncols = [starts[s + 1] - starts[s] for s in range(ns0)]
    nrows_below = [len(st[starts[s + 1] - 1]) for s in range(ns0)]
    eff_start = list(starts[:-1])
    useful_prefix = np.zeros(n + 1, dtype=np.int64)
    for j in range(n):
        useful_prefix[j + 1] = useful_prefix[j] + (2 * (len(st[j]) + 1) - 1)
    for s in range(ns0 - 1, -1, -1):
        p = sparent[s]
        if p == -1:
            continue
        pr = merge_into[p]
        while merge_into[pr] != pr:
            pr = merge_into[pr]
        if starts[s + 1] != eff_start[pr]:
            continue
        b = nrows_below[pr]
        mc = ncols[s] + ncols[pr]
        mf = mc + b
        c0 = starts[s]
        useful = int(useful_prefix[c0 + mc] - useful_prefix[c0]) + b * b
        zeros_total = mf * mf - useful
        frac = (
            relax_frac if mc <= 16
            else 0.5 * relax_frac if mc <= 64
            else 0.2 * relax_frac if mc <= 256
            else 0.04 * relax_frac
        )
        child_front = ncols[s] + nrows_below[s]
        small = (child_front <= relax_small
                 and zeros_total <= relax_frac * mf * mf)
        if small or zeros_total <= frac * mf * mf:
            merge_into[s] = pr
            ncols[pr] += ncols[s]
            eff_start[pr] = starts[s]
    for s in range(ns0):
        t = s
        while merge_into[t] != t:
            t = merge_into[t]
        merge_into[s] = t

    roots2 = sorted(
        (t for t in range(ns0) if merge_into[t] == t),
        key=lambda t: min(starts[s] for s in range(ns0) if merge_into[s] == t),
    )
    new_id = {t: k for k, t in enumerate(roots2)}
    nsuper = len(roots2)
    sup_of2 = np.empty(n, dtype=np.int64)
    for s in range(ns0):
        sup_of2[starts[s]: starts[s + 1]] = new_id[merge_into[s]]
    sup_start = np.zeros(nsuper + 1, dtype=np.int32)
    for j in range(n):
        sup_start[sup_of2[j] + 1] = j + 1

    sup_parent = np.full(nsuper, -1, dtype=np.int32)
    for t in range(nsuper):
        last = sup_start[t + 1] - 1
        p = parent[last]
        sup_parent[t] = -1 if p == -1 else sup_of2[p]

    rows_ptr = np.zeros(nsuper + 1, dtype=np.int32)
    rows_list = []
    lnnz = 0
    max_front = max_piv = 0
    for t in range(nsuper):
        c0, c1 = int(sup_start[t]), int(sup_start[t + 1])
        below = sorted(
            {r for j in range(c0, c1) for r in st[j] if r >= c1}
        )
        front = list(range(c0, c1)) + below
        rows_list.append(np.asarray(front, dtype=np.int32))
        rows_ptr[t + 1] = rows_ptr[t] + len(front)
        lnnz += (c1 - c0) * len(front)
        max_front = max(max_front, len(front))
        max_piv = max(max_piv, c1 - c0)
    rows = (
        np.concatenate(rows_list)
        if rows_list
        else np.zeros(0, dtype=np.int32)
    )

    sup_level = np.zeros(nsuper, dtype=np.int32)
    for t in range(nsuper):
        p = sup_parent[t]
        if p != -1:
            sup_level[p] = max(sup_level[p], sup_level[t] + 1)
    height = int(sup_level.max()) if nsuper else 0

    return {
        "nsuper": nsuper,
        "sup_start": sup_start,
        "sup_parent": sup_parent,
        "sup_level": sup_level,
        "rows_ptr": rows_ptr,
        "rows": rows,
        "lnnz": int(lnnz),
        "height": height,
        "max_front": max_front,
        "max_pivots": max_piv,
    }
