"""Direct solve walkthrough on the PyTorch port: the staged analyze ->
factor -> solve pipeline, on the card.

The counterpart of ``poisson_direct.py``: what the reference's UMFPACK
layer offers (Umfpack.hs:38-102) plus the factor-query surface, on the
64**2 Poisson operator in f64.  Runs on the CUDA card by default; pass
``--device cpu`` for the CPU.

    python examples/torch_poisson_direct.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import torch

import sparse_linear_tpu_torch as st
from sparse_linear_tpu_torch.solve import api as solve
from sparse_linear_tpu_torch.solve import multifrontal as mf
from sparse_linear_tpu_torch.utils.grids import poisson_2d


def device_line(dev: torch.device) -> str:
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    return f"device: {dev} ({name})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    print(device_line(dev))
    g = 64
    n = g * g
    a = poisson_2d(g, dtype=torch.float64, device=dev)  # 5-point, CSR
    b = torch.ones(n, dtype=torch.float64, device=dev)

    # one-shot convenience (reference `linearSolve` / <\>)
    x = solve.linear_solve(a, b)
    print("one-shot residual:", float(solve.residual_norm(a, x, b)))

    # staged: one symbolic analysis, many numeric factorizations
    # (the FEAST usage pattern, Feast.hs:210-218)
    sym = mf.analyze(a, dims=(g, g))  # geometric nested dissection
    f = mf.factor(a, sym, kind="cholesky")  # SPD -> Cholesky fronts
    x = mf.solve(f, b)
    print("multifrontal residual:",
          float(torch.linalg.vector_norm(st.spmv(a, x) - b)
                / torch.linalg.vector_norm(b)))

    # transpose solves reuse the same factors (UMFPACK sys=0/1/2)
    xt = mf.solve(f, b, trans=True)
    del xt

    # mixed-precision refinement: f32 factors + f64 residuals
    a32 = a.map_values(lambda v: v.to(torch.float32))
    f32 = mf.factor(a32, mf.analyze(a32, dims=(g, g)), kind="cholesky")
    x64, info = solve.solve_refined(f32, a, b, tol=1e-10)
    print("refined residual:", float(info.residual_norm),
          "steps:", info.refinement_steps, "converged:", info.converged)
    assert info.converged

    # factor queries (umfpack get_determinant / Info[RCOND] / get_numeric)
    sign, logabs = solve.slogdet(f)
    print("slogdet:", float(torch.as_tensor(sign).real), float(logabs))
    print("rcond estimate:", float(solve.rcond(f)))
    print("condest (1-norm):", float(solve.condest(f, a)))
    solve.get_factors(f)
    print("factor nnz:", solve.lunz(f))

    # shifted batch: factor many value-sets over one pattern in one call
    shifts = [0.5, 1.0, 2.0]
    eye = st.eye(n, dtype=torch.float64, device=dev)
    stacks = torch.stack([st.lin(1.0, a, -s, eye).data for s in shifts])
    pattern = st.lin(1.0, a, -shifts[0], eye)
    fb = solve.factor_batched(pattern, stacks,
                              mf.analyze(pattern, dims=(g, g)))
    xs = solve.solve_batched(fb, b.expand(3, n)[..., None])
    print("batched shifted solves:", tuple(xs.shape))


if __name__ == "__main__":
    main()
