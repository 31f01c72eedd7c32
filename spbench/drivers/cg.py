"""CG to the configuration's tolerance, one new right-hand side a request.

Set-up: the configuration's operator as triples on the device (renumbered
by a permutation drawn from ``permutation_seed`` where the workload's
``order`` is ``shuffled``), assembled by the port (``from_triples``), put
in the format the port picks (``to_fast_format``), and a warm-up CG of
``warmup_iters`` iterations.  Request i: b drawn from (seed, i) in grid
order (renumbered with the unknowns), then the port's ``cg`` from x = 0 to
``tol * ||b||``.  A sample of the answers, drawn from the seed, and the
last are kept; the check recomputes each one's true residual through the
reference product of the same triples.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import torch

from spbench.harness import sampled, substream
from spbench.operators import generator
from spbench.reference import product


def _permutation(n: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randperm(n, generator=gen, device=device)


def _operator(st):
    """The benchmark's triples of the cell's operator, float64."""
    rows, cols, vals = st.gen.triples(st.grid, torch.float64, st.device)
    if st.perm is not None:
        rows, cols = st.perm[rows], st.perm[cols]
    return rows, cols, vals


def _rhs(st, i: int) -> torch.Tensor:
    gen = torch.Generator(device=st.device).manual_seed(
        substream(st.seed, i + 1))
    b = torch.randn(st.n, dtype=torch.float64, device=st.device,
                    generator=gen)
    if st.perm is None:
        return b
    out = torch.empty_like(b)
    out[st.perm] = b
    return out


def setup(ctx):
    wl, cfg, run = ctx.workload, ctx.config, ctx.run
    with run.stage("import"):
        from sparse_linear_tpu_torch.formats.matrix import from_triples
        from sparse_linear_tpu_torch.formats.select import to_fast_format
        from sparse_linear_tpu_torch.solve import cg as cg_mod
    grid = list(cfg["grid"])
    n = math.prod(grid)
    st = SimpleNamespace(seed=ctx.seed, device=ctx.device, grid=grid, n=n,
                         gen=generator(cfg),
                         dtype=ctx.dtype, tol=float(cfg["tolerance"]),
                         maxiter=int(wl["maxiter"]),
                         rate=float(wl["check_rate"]), run=run, perm=None,
                         kept={}, cg=cg_mod)
    with run.stage("operator"):
        if wl["order"] == "shuffled":
            st.perm = _permutation(n, int(wl["permutation_seed"]),
                                   ctx.device)
        rows, cols, vals = _operator(st)
        coo = from_triples((n, n), rows, cols, vals.to(ctx.dtype))
        del rows, cols, vals
        st.op = to_fast_format(coo)
        nnz = coo.nnz
        del coo
    run.info.update(n=n, nnz=nnz, format=type(st.op).__name__,
                    itemsize=torch.empty((), dtype=ctx.dtype).element_size())
    ctx.log(f"cg: n {n}, nnz {nnz}, format {type(st.op).__name__}, "
            f"{ctx.dtype}")
    with run.stage("warmup"):
        b = _rhs(st, -1).to(ctx.dtype)
        cg_mod.cg(st.op.__matmul__, b, tol=st.tol,
                  maxiter=int(wl["warmup_iters"]))
    return st


def prepare(st, i: int) -> None:
    st.b = _rhs(st, i).to(st.dtype)


def serve(st, i: int) -> bool:
    with st.run.span("cg"):
        res = st.cg.cg(st.op.__matmul__, st.b, tol=st.tol,
                       maxiter=st.maxiter)
    st.run.count("cg.iterations", res.iterations)
    if sampled(st.seed, i, st.rate):
        st.kept[i] = res.x
    st.last = (i, res.x)
    return bool(res.converged)


def release(st) -> None:
    st.op = st.b = None


def check(st) -> dict:
    kept = dict(st.kept)
    kept[st.last[0]] = st.last[1]
    rows, cols, vals = _operator(st)
    worst = max(product.relative_residual(rows, cols, vals, x, _rhs(st, i))
                for i, x in kept.items())
    return {"resid": worst}
