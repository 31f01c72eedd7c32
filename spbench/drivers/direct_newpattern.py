"""A new mesh with every request: analyze, first factor and solve.

An adaptive finite-element code remeshes at every step and hands each new
mesh to a sparse direct solver, as the reference's one-shot
``linearSolve`` / ``<\\>`` does: symbolic analysis, numeric factor and
solve on every call.  Request i brings a new unstructured 2D mesh
(``operators/mesh2d.py``: node count, aspect, jitter, diagonals and
numbering drawn from (seed, i)), the triples of its P1 operator
-div(grad u) + u with every duplicate left in, and a random b.
Set-up: one such mesh served whole as a warm-up request, untimed.
Request i (timed from the hand-off of the triples until x is ready): the
port's ``from_triples`` and CSR (span ``assembly``), its ``analyze`` with
no grid dims and no ordering, so the port picks its own (span
``analyze``), its Cholesky ``factor``, the first and only one on that
symbolic (span ``factor``), and its ``solve`` (span ``solve``).  The
port's failure is read: ``serve`` returns False where the factor broke
down.  The symbolic's
record of its stages (``MFSymbolic.stats``, where the port keeps one) goes
to the run's counters ``analyze.<key>``; then the symbolic, the factors
and the request's inputs are dropped, and on a card the allocator's level
is kept for the log.  Making the mesh, its triples and b is the
benchmark's work, done before the request's timer starts.  A sample of the
answers, drawn from the seed, and the last are kept on the host; the check
makes their triples again and recomputes each true residual through the
reference product.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from spbench.harness import sampled, substream
from spbench.operators import generator
from spbench.reference import product


def size(seed: int, i: int) -> float:
    """Where request i's node count lies in the configuration's range, as
    a share of the way across it on a log scale: drawn for each request
    alone from (seed, i), uniform in [0, 1), so each mesh's node count is
    log-uniform and independent of the other requests'."""
    return substream(seed, i, 0x51E) / 2.0 ** 62


def _inputs(st, i: int):
    """(n, rows, cols, vals, b) of request i, float64."""
    gen = torch.Generator(device=st.device).manual_seed(
        substream(st.seed, i + 1))
    return st.gen.request(st.config, size(st.seed, i), gen, st.device)


def setup(ctx):
    run = ctx.run
    with run.stage("import"):
        from sparse_linear_tpu_torch.formats.matrix import from_triples
        from sparse_linear_tpu_torch.solve import api
    st = SimpleNamespace(seed=ctx.seed, device=ctx.device, config=ctx.config,
                         gen=generator(ctx.config), dtype=ctx.dtype,
                         rate=float(ctx.workload["check_rate"]), run=run,
                         kept={}, levels=[], log=ctx.log, api=api,
                         from_triples=from_triples)
    with run.stage("inputs"):
        prepare(st, -1)
    ctx.log(f"direct_newpattern: making one request's mesh, triples and b "
            f"takes {run.stages['inputs']:.4f} s (the benchmark's work); "
            f"warm-up mesh n {st.n}, {len(st.vals)} triples, {ctx.dtype}")
    with run.stage("warmup"):
        serve(st, -1)
    st.kept.clear()
    st.levels.clear()
    run.spans.clear()
    run.counters.clear()
    return st


def prepare(st, i: int) -> None:
    st.n, st.rows, st.cols, vals, b = _inputs(st, i)
    st.vals, st.b = vals.to(st.dtype), b.to(st.dtype)


def serve(st, i: int) -> bool:
    run = st.run
    with run.span("assembly"):
        mat = st.from_triples((st.n, st.n), st.rows, st.cols,
                              st.vals).tocsr()
    with run.span("analyze"):
        sym = st.api.analyze(mat, backend="multifrontal")
    with run.span("factor"):
        fac = st.api.factor(mat, sym, backend="multifrontal",
                            kind="cholesky")
    with run.span("solve"):
        x = st.api.solve(fac, st.b)
    ok = not fac.breakdown
    for key, value in (getattr(sym, "stats", None) or {}).items():
        run.count("analyze." + key, value)
    x = x.cpu()
    if sampled(st.seed, i, st.rate):
        st.kept[i] = x
    st.last = (i, x)
    del mat, sym, fac
    st.rows = st.cols = st.vals = st.b = None
    if st.device.type == "cuda":
        st.levels.append(torch.cuda.memory_allocated(st.device))
    return ok


def release(st) -> None:
    if st.levels:
        st.log("direct_newpattern: the allocator's level after each "
               "request, MB: " + " ".join(f"{v / 2**20:.3f}"
                                          for v in st.levels))


def check(st) -> dict:
    kept = dict(st.kept)
    kept[st.last[0]] = st.last[1]
    worst = 0.0
    for i, x in kept.items():
        n, rows, cols, vals, b = _inputs(st, i)
        if x.shape != (n,):  # an answer of another request
            return {"resid": math.inf}
        worst = max(worst, product.relative_residual(
            rows, cols, vals, x.to(st.device), b))
    return {"resid": worst}
