"""Helpers for the parity tests between the JAX package and its PyTorch port.

Inputs are made once with numpy and handed to both packages; a JAX matrix
crosses to the port through ``interop.jax_state`` as numpy leaves (a JAX
WELL or WELL64 as its chunk planes, which the port decodes and repacks in
its own layout).
"""

import numpy as np

from sparse_linear_tpu.formats.matrix import COO, CSC, CSR, from_triples
from sparse_linear_tpu.formats.structured import DIA
from sparse_linear_tpu.formats.well import WELL
from sparse_linear_tpu.kernels.spmv_well64 import WELL64
from sparse_linear_tpu.utils import grids as jgrids

_LEAVES = {
    COO: ("coo", ("row", "col", "data")),
    CSR: ("csr", ("indptr", "indices", "data")),
    CSC: ("csc", ("indptr", "indices", "data")),
    DIA: ("dia", ("data",)),
}


def permuted_poisson(g, dtype, seed=7):
    """The g**2 five-point operator (JAX package) with rows and columns
    relabelled by one seeded permutation; values cast to ``dtype`` (a
    complex dtype gets a seeded imaginary part on the same pattern)."""
    a = jgrids.poisson_2d(g, dtype=np.float64).tocoo()
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g * g)
    vals = np.asarray(a.data)
    if np.issubdtype(dtype, np.complexfloating):
        vals = vals + 1j * rng.standard_normal(vals.size)
    return from_triples((g * g, g * g), perm[np.asarray(a.row)],
                        perm[np.asarray(a.col)],
                        vals.astype(dtype)).tocsr()


def jax_arrays(m):
    """(kind, {leaf: numpy array}, shape, offsets) of a JAX-package matrix."""
    if isinstance(m, (WELL, WELL64)):
        w = m.well if isinstance(m, WELL64) else m
        arrays = {n: np.asarray(getattr(w, n))
                  for n in ("bases", "idx", "vals")}
        if isinstance(m, WELL64):
            arrays["vals_lo"] = np.asarray(m.vals_lo)
            return "well64", arrays, tuple(m.shape), None
        if w.vals_im is not None:
            arrays["vals_im"] = np.asarray(w.vals_im)
        return "well", arrays, tuple(m.shape), None
    kind, names = _LEAVES[type(m)]
    arrays = {n: np.asarray(getattr(m, n)) for n in names}
    return kind, arrays, tuple(m.shape), getattr(m, "offsets", None)


def to_port(m, device="cpu"):
    """The port's counterpart of a JAX-package matrix."""
    from sparse_linear_tpu_torch.interop.jax_state import from_arrays

    return from_arrays(*jax_arrays(m), device=device)


def to_jax(m):
    """The JAX package's counterpart of a port matrix."""
    import jax.numpy as jnp

    from sparse_linear_tpu_torch.interop.jax_state import to_arrays

    kind, arrays, shape, offsets = to_arrays(m)
    cls = {"coo": COO, "csr": CSR, "csc": CSC, "dia": DIA}[kind]
    leaves = {n: jnp.asarray(a) for n, a in arrays.items()}
    if kind == "dia":
        return DIA(data=leaves["data"], shape=shape, offsets=offsets)
    if kind == "coo":
        return COO(**leaves, shape=shape, nnz=m.nnz)
    return cls(**leaves, shape=shape)


def np_of(t):
    """numpy copy of a torch tensor or JAX array."""
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def assert_same_leaves(port_mat, jax_mat, atol=1e-12):
    """Index leaves equal, value leaves within ``atol``, same shape."""
    from sparse_linear_tpu_torch.interop.jax_state import to_arrays

    kind, arrays, shape, offsets = to_arrays(port_mat)
    jkind, jarrays, jshape, joffsets = jax_arrays(jax_mat)
    assert (kind, shape) == (jkind, jshape)
    if kind == "dia":
        assert tuple(offsets) == tuple(joffsets)
    for name, a in arrays.items():
        b = jarrays[name]
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if name == "data":
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        else:
            np.testing.assert_array_equal(a, b)
