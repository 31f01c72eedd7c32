"""Monte Carlo refactoring: one coefficient field a request, one pattern.

Uncertainty quantification of -div(kappa grad u) = f: each request brings
the values of the operator for a new lognormal field kappa (``operators/
lognormal.py``, ``sigma`` and ``corr`` from the workload), on the fixed
grid pattern.  Set-up: the pattern on the device, the port's ``analyze``
of it once (multifrontal, nested dissection by the grid's dims), and one
whole warm-up request.  Request i (timed from the hand-off of the triples
until x is ready): the port's ``from_triples`` and CSR (span
``assembly``), its Cholesky ``factor`` on the symbolic analysis (span
``factor``), its ``solve`` (span ``solve``).  Making kappa_i and b_i from
(seed, i) is the benchmark's work, done before the request's timer starts.
A sample of the answers, drawn from the seed, and the last are kept; the
check makes kappa_i and b_i again and recomputes each true residual
through the reference product of the same triples.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from spbench.harness import sampled, substream
from spbench.operators import generator, lognormal
from spbench.reference import product


def _inputs(st, i: int):
    """(values of the triples, b) of request i, float64."""
    gen = torch.Generator(device=st.device).manual_seed(
        substream(st.seed, i + 1))
    kappa = lognormal.field(st.grid, st.sigma, st.corr, gen, st.device)
    vals = st.gen.values(st.grid, torch.float64, st.device, kappa)
    b = torch.randn(st.n, dtype=torch.float64, device=st.device,
                    generator=gen)
    return vals, b


def setup(ctx):
    wl, cfg, run = ctx.workload, ctx.config, ctx.run
    with run.stage("import"):
        from sparse_linear_tpu_torch.formats.matrix import from_triples
        from sparse_linear_tpu_torch.solve import api
    grid = list(cfg["grid"])
    n = math.prod(grid)
    st = SimpleNamespace(seed=ctx.seed, device=ctx.device, grid=grid, n=n,
                         gen=generator(cfg),
                         dtype=ctx.dtype, sigma=float(wl["sigma"]),
                         corr=float(wl["corr"]), rate=float(wl["check_rate"]),
                         run=run, kept={}, api=api,
                         from_triples=from_triples)
    with run.stage("operator"):
        st.rows, st.cols = st.gen.pattern(grid, ctx.device)
        vals, _ = _inputs(st, -1)
        mat = from_triples((n, n), st.rows, st.cols, vals.to(ctx.dtype))
        del vals
    with run.span("analyze"):
        st.sym = api.analyze(mat, backend="multifrontal", dims=tuple(grid))
    ctx.log(f"direct_refactor: n {n}, nnz {mat.nnz}, {ctx.dtype}, "
            f"analyze {run.spans['analyze'][0][0]:.4f} s")
    with run.stage("inputs"):
        prepare(st, -1)
    ctx.log(f"direct_refactor: making one request's kappa, values and b "
            f"takes {run.stages['inputs']:.4f} s (the benchmark's work)")
    with run.stage("warmup"):
        serve(st, -1)
        st.kept.clear()
        for name in ("assembly", "factor", "solve"):
            run.spans.pop(name, None)
    return st


def prepare(st, i: int) -> None:
    vals, b = _inputs(st, i)
    st.vals, st.b = vals.to(st.dtype), b.to(st.dtype)


def serve(st, i: int) -> bool:
    with st.run.span("assembly"):
        mat = st.from_triples((st.n, st.n), st.rows, st.cols,
                              st.vals).tocsr()
    with st.run.span("factor"):
        fac = st.api.factor(mat, st.sym, backend="multifrontal",
                            kind="cholesky")
    with st.run.span("solve"):
        x = st.api.solve(fac, st.b)
    if sampled(st.seed, i, st.rate):
        st.kept[i] = x
    st.last = (i, x)
    return True


def release(st) -> None:
    st.sym = st.vals = st.b = None


def check(st) -> dict:
    kept = dict(st.kept)
    kept[st.last[0]] = st.last[1]
    worst = 0.0
    for i, x in kept.items():
        vals, b = _inputs(st, i)
        worst = max(worst, product.relative_residual(st.rows, st.cols, vals,
                                                     x, b))
    return {"resid": worst}
