"""Helpers for the parity tests between the JAX package and its PyTorch port.

Inputs are made once with numpy and handed to both packages; a JAX matrix
crosses to the port through ``interop.jax_state`` as numpy leaves.
"""

import numpy as np

from sparse_linear_tpu.formats.matrix import COO, CSC, CSR
from sparse_linear_tpu.formats.structured import DIA

_LEAVES = {
    COO: ("coo", ("row", "col", "data")),
    CSR: ("csr", ("indptr", "indices", "data")),
    CSC: ("csc", ("indptr", "indices", "data")),
    DIA: ("dia", ("data",)),
}


def jax_arrays(m):
    """(kind, {leaf: numpy array}, shape, offsets) of a JAX-package matrix."""
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
