"""Where the port's constructors build: on the card unless asked otherwise.

Each constructor that makes tensors from nothing or from host arrays runs
on the CUDA card when it is given no ``device=``; on a machine without a
GPU that call raises torch's own error rather than falling back to the
CPU.  Given ``device="cpu"``, or inputs that are already CPU tensors, it
stays on the CPU.  No JAX here: this is the port's own contract.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sp = pytest.importorskip("scipy.sparse")

import sparse_linear_tpu_torch as st  # noqa: E402
from sparse_linear_tpu_torch.interop import jax_state, scipy_io  # noqa: E402
from sparse_linear_tpu_torch.utils import grids  # noqa: E402

DENSE = np.array([[2.0, 0.0, -1.0], [0.0, 3.0, 0.0], [-1.0, 0.0, 4.0]])
CSR_ARRAYS = {"indptr": np.array([0, 2, 3, 5]),
              "indices": np.array([0, 2, 1, 0, 2]),
              "data": np.array([2.0, -1.0, 3.0, -1.0, 4.0])}
ROWS = np.array([0, 0, 1, 2, 2])


def _csr_arrays(arr):
    return {k: arr(v) for k, v in CSR_ARRAYS.items()}


# name -> (build(arr, **kw), whether it takes arrays): ``arr`` turns each
# numpy input into the form under test (the host array itself, or a CPU
# tensor)
CONSTRUCTORS = {
    "laplacian_1d": (lambda arr, **kw: grids.laplacian_1d(5, **kw), False),
    "poisson_2d": (lambda arr, **kw: grids.poisson_2d(3, **kw), False),
    "poisson_3d": (lambda arr, **kw: grids.poisson_3d(2, **kw), False),
    "eye": (lambda arr, **kw: st.eye(3, **kw), False),
    "zeros": (lambda arr, **kw: st.zeros((2, 3), **kw), False),
    "from_triples": (lambda arr, **kw: st.from_triples(
        (3, 3), arr(ROWS), arr(CSR_ARRAYS["indices"]),
        arr(CSR_ARRAYS["data"]), **kw), True),
    "diag": (lambda arr, **kw: st.diag(arr(CSR_ARRAYS["data"]), **kw), True),
    "from_dense": (lambda arr, **kw: st.from_dense(arr(DENSE), **kw), True),
    "scipy_io.from_scipy": (lambda arr, **kw: scipy_io.from_scipy(
        sp.csr_matrix(DENSE), **kw), False),
    "scipy_io.from_arrays": (lambda arr, **kw: scipy_io.from_arrays(
        {"format": "csr", "shape": (3, 3), **_csr_arrays(arr)}, **kw), True),
    "jax_state.from_arrays": (lambda arr, **kw: jax_state.from_arrays(
        "csr", _csr_arrays(arr), (3, 3), **kw), True),
}


def _host(a):
    return a


def _cpu_tensor(a):
    return torch.as_tensor(a)


def _devices(m):
    return {f.device.type for f in (getattr(m, n, None) for n in (
        "data", "indptr", "indices", "row", "col")) if f is not None}


@pytest.mark.parametrize("how", ["no_device", "cpu"])
@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_builds_on_the_card_unless_asked(name, how):
    build, takes_arrays = CONSTRUCTORS[name]
    if how == "no_device":
        if torch.cuda.is_available():
            assert _devices(build(_host)) == {"cuda"}
        else:
            # no GPU here: torch's own error, never a quiet CPU fallback
            with pytest.raises((AssertionError, RuntimeError)):
                build(_host)
        return
    m = build(_cpu_tensor) if takes_arrays else build(_host, device="cpu")
    assert _devices(m) == {"cpu"}
    # the same matrix as from host inputs with device="cpu"
    np.testing.assert_array_equal(
        m.tocsr().todense().numpy(),
        build(_host, device="cpu").tocsr().todense().numpy())
