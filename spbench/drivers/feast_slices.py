"""Spectrum slicing with FEAST: consecutive windows of about ``per_window``
eigenvalues, one ``eigsh`` a window, back to back.

The window edges lie in the widest gap of the analytic spectrum within
``slack`` positions of each multiple of ``per_window`` (the 2D spectrum is
full of double eigenvalues, which an edge must not split).  Set-up: the
operator from triples (the port's ``from_triples`` and CSR), and one cold
``eigsh`` of the lowest window [0, edge 1), which pays the port's
``analyze`` of the pattern once.  Request i: the window [edge i+1,
edge i+2) through ``eigsh(m0, window, A, params)``, its random start drawn
from (seed, i); the same windows in every run, none twice.  Every
answer's eigenvalues are kept, and the vectors of a sample drawn from the
seed and of the last; the check compares the count and the values with
the closed-form spectrum, and the kept vectors' residuals (through the
reference product of the same triples) and orthonormality.
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch

from spbench.harness import sampled, substream
from spbench.operators import generator
from spbench.reference import product, spectrum, subspace


def slice_edges(lam: np.ndarray, per_window: int, slack: int,
                count: int) -> list:
    """``count`` window edges: edge k in the widest gap between
    lam[p - 1] and lam[p] for p within ``slack`` of ``k * per_window``."""
    edges = []
    for k in range(1, count + 1):
        lo = max(1, k * per_window - slack)
        hi = min(len(lam) - 1, k * per_window + slack)
        p = lo + int(np.argmax(lam[lo:hi + 1] - lam[lo - 1:hi]))
        edges.append(float((lam[p - 1] + lam[p]) / 2))
    return edges


def setup(ctx):
    wl, cfg, run = ctx.workload, ctx.config, ctx.run
    with run.stage("import"):
        from sparse_linear_tpu_torch.eig import feast, pipeline
        from sparse_linear_tpu_torch.formats.matrix import from_triples
    grid = list(cfg["grid"])
    n = math.prod(grid)
    lam = spectrum.eigenvalues(grid)
    st = SimpleNamespace(
        seed=ctx.seed, device=ctx.device, grid=grid, n=n, lam=lam,
        gen=generator(cfg),
        m0=int(wl["m0"]), rate=float(wl["check_rate"]), run=run,
        edges=slice_edges(lam, int(wl["per_window"]), int(wl["slack"]),
                          int(wl["windows"]) + 1),
        params=feast.FeastParams(
            tol=float(cfg["tolerance"]), dims=tuple(grid),
            backend="multifrontal",
            contour_points=int(wl["contour_points"])),
        feast=feast, pipeline=pipeline, answers=[], vectors={},
        modes=set(), windows=[], log=ctx.log)
    with run.stage("operator"):
        rows, cols, vals = st.gen.triples(grid, torch.float64, ctx.device)
        st.a = from_triples((n, n), rows, cols, vals.to(ctx.dtype)).tocsr()
        del rows, cols, vals
    with run.stage("cold_window"):
        res = feast.eigsh(st.m0, (0.0, st.edges[0]), st.a, st.params)
    run.spans["feast.analyze"] = [(pipeline.last_run["analyze_s"], False)]
    ctx.log(f"feast_slices: n {n}, lowest window {res.n_found} pairs in "
            f"{res.iterations} loops, contour {pipeline.last_run['mode']}, "
            f"analyze {pipeline.last_run['analyze_s']:.4f} s, {ctx.dtype}")
    return st


def prepare(st, i: int) -> None:
    st.window = (st.edges[i + 1], st.edges[i + 2])
    st.params_i = dataclasses.replace(
        st.params, seed=substream(st.seed, i + 1))


def serve(st, i: int) -> bool:
    with st.run.span("eig"):
        res = st.feast.eigsh(st.m0, st.window, st.a, st.params_i)
    last = st.pipeline.last_run
    loops = last["loops"]
    st.run.count("feast.loops", len(loops))
    st.run.count("feast.solves_s", sum(lp["solve_s"] for lp in loops))
    st.run.count("feast.factor_s", last["factor_s"]
                 + sum(lp["factor_s"] for lp in loops))
    st.modes.add(last["mode"])
    stats = torch.cuda.memory_stats(st.device) if st.device.type == "cuda" \
        else {}
    st.windows.append(
        f"{i}: {len(loops)} loops {st.run.spans['eig'][-1][0]:.3f} s "
        f"(factor {last['factor_s']:.3f}) {last['mode']}, allocator "
        f"retries {stats.get('num_alloc_retries', 0)} device mallocs "
        f"{stats.get('num_device_alloc', 0)}")
    st.answers.append((i, st.window, np.asarray(res.values)))
    if sampled(st.seed, i, st.rate):
        st.vectors[i] = (res.values, res.vectors)
    st.last = (i, (res.values, res.vectors))
    return res.info == st.feast.INFO_OK


def release(st) -> None:
    st.pipeline.clear_pipeline_cache()
    st.a = None
    st.log(f"feast_slices: contour modes in the window {sorted(st.modes)}; "
           "windows " + "; ".join(st.windows))


def check(st) -> dict:
    """count: the most pairs any window missed or added; eig_err: the
    largest gap between a window's values and its closed-form eigenvalues,
    both sorted, element by element (where the counts differ, from each
    value to the nearest eigenvalue), so a pair lost and another returned
    twice shows; resid: the largest ||A v - lambda v|| / ||v|| of a kept
    vector; orth: the largest entry of |V^H V - I| over a kept window's
    vectors, so a vector returned twice within a double eigenvalue shows;
    eig_err and resid on the scale max(|emin|, |emax|, 1), as FEAST's
    own."""
    count = eig_err = 0.0
    for _, window, got in st.answers:
        want = spectrum.inside(st.lam, window)
        scale = max(abs(window[0]), abs(window[1]), 1.0)
        count = max(count, abs(len(got) - len(want)))
        if len(got) == len(want):
            gap = np.abs(np.sort(got) - want)
        elif len(got) and len(want):
            gap = np.abs(got[:, None] - want[None, :]).min(axis=1)
        else:
            gap = np.array([math.inf])
        if gap.size:
            eig_err = max(eig_err, float(gap.max()) / scale)
    vectors = dict(st.vectors)
    vectors[st.last[0]] = st.last[1]
    rows, cols, vals = st.gen.triples(st.grid, torch.float64, st.device)
    resid = orth = 0.0
    for i, (values, vecs) in vectors.items():
        window = st.answers[[a[0] for a in st.answers].index(i)][1]
        scale = max(abs(window[0]), abs(window[1]), 1.0)
        v = vecs.to(torch.float64)
        lam = torch.as_tensor(np.asarray(values), dtype=torch.float64,
                              device=v.device)
        r = product.matvec(rows, cols, vals, v) - v * lam[None, :]
        norms = (torch.linalg.vector_norm(r, dim=0)
                 / torch.linalg.vector_norm(v, dim=0))
        if norms.numel():
            resid = max(resid, float(norms.max()) / scale)
            orth = max(orth, subspace.orthonormality_gap(v))
    return {"count": count, "eig_err": eig_err, "resid": resid,
            "orth": orth}
