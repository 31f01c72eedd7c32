"""Kernel walkthrough on the PyTorch port: f64 unstructured SpMV and the
one-launch DIA chain, the hand-written Hopper kernels.

The counterpart of ``kernels_f64.py``.  The TPU answers there (paired-f32
hi/lo value planes, a VMEM-resident chain) work around a 32-bit gather and
a small scratchpad; the H100 has neither limit, so:

1. kernel C ``<double>`` (``kernels.spmv_well.well_spmv``): f64 WELL SpMV
   with native f64 values, one packing, no hi/lo planes
   (``kernels.spmv_well64`` keeps the JAX package's names over it);
2. kernel B (``kernels.spmv_dia.dia_spmv_chain``): (alpha A)^k x as ONE
   cooperative launch with a grid-wide barrier between the k steps.

Runs on the CUDA card by default, where the kernels are built with nvcc at
first use; with ``--device cpu`` each wrapper runs its plain PyTorch
version, and the script says so.

    python examples/torch_kernels_f64.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

import numpy as np
import torch

from sparse_linear_tpu_torch.kernels.spmv_dia import (
    dia_spmv_chain,
    dia_spmv_kernel,
)
from sparse_linear_tpu_torch.kernels.spmv_well import well_spmv
from sparse_linear_tpu_torch.kernels.spmv_well64 import (
    csr_to_well64,
    well_spmv64,
)
from sparse_linear_tpu_torch.utils.grids import poisson_2d


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "host"
    print(f"device: {dev} ({name})")
    on_card = dev.type == "cuda"
    c0, b0 = well_spmv.launches, dia_spmv_chain.launches

    # --- f64 WELL: native f64 values, kernel C <double> ------------------
    g = 48
    n = g * g
    a64 = poisson_2d(g, dtype=torch.float64, device=dev)
    w = csr_to_well64(a64)  # one packing, f64 values
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(n),
                        device=dev)
    y = well_spmv64(w, x)
    import scipy.sparse as sp

    As = sp.csr_matrix(
        (a64.data.cpu().numpy(), a64.indices.cpu().numpy(),
         a64.indptr.cpu().numpy()), shape=a64.shape)
    ref = As @ x.cpu().numpy()
    rel = np.linalg.norm(y.cpu().numpy() - ref) / np.linalg.norm(ref)
    print(f"f64 WELL SpMV (kernel C <double>): rel error {rel:.2e} "
          "against scipy")
    assert rel < 1e-12

    # --- the one-launch chain, kernel B ----------------------------------
    gd = 32
    ad = poisson_2d(gd, dtype=torch.float32, fmt="dia", device=dev)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(gd * gd),
                        dtype=torch.float32, device=dev)
    yk = dia_spmv_chain(ad, v, k=5, alpha=0.2)
    chained = v
    for _ in range(5):
        chained = dia_spmv_kernel(ad, chained, alpha=0.2)
    same = bool(torch.allclose(yk, chained, rtol=1e-5, atol=1e-6))
    print("chain (alpha A)^5 x matches 5 chained SpMVs (kernel A):", same)
    assert same

    ran = {"kernel C": well_spmv.launches - c0,
           "kernel B": dia_spmv_chain.launches - b0}
    if on_card:
        print(f"kernel launches on {dev}: {ran}")
        assert all(v >= 1 for v in ran.values()), ran
    else:
        print("on the CPU the wrappers ran their plain PyTorch versions "
              "(no kernel is built or launched off the card)")


if __name__ == "__main__":
    main()
