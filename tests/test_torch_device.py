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
    # "row" / "col" are COO's index fields and CSR's / CSC's segment methods
    return {f.device.type for f in (getattr(m, n, None) for n in (
        "data", "indptr", "indices", "row", "col"))
        if isinstance(f, torch.Tensor)}


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


def test_direct_solver_stays_on_the_cpu_with_cpu_inputs():
    """analyze -> factor -> solve on CPU tensors: every block, diagnostic
    and solution lies on the CPU (no probe, no move to the card)."""
    from sparse_linear_tpu_torch.solve import api, multifrontal as mf

    a = grids.poisson_2d(6, dtype=torch.float64, device="cpu")
    sym = api.analyze(a, backend="multifrontal", ordering="amd")
    for kind in ("lu", "cholesky"):
        f = api.factor(a, sym, backend="multifrontal", kind=kind,
                       scale="sum")
        devs = {t.device.type for blk in f.blocks.values()
                for t in blk.values()}
        assert devs == {"cpu"} and f.device.type == "cpu"
        x = api.solve(f, np.ones(36))
        assert x.device.type == "cpu"
        fb = mf.factor_batched(torch.stack([a.data, 2 * a.data]), sym,
                               kind=kind)
        assert {t.device.type for blk in fb.blocks.values()
                for t in blk.values()} == {"cpu"}
    assert set(sym._dev_maps) == {"cpu"}


def test_factor_batched_of_host_arrays_goes_to_the_card():
    from sparse_linear_tpu_torch.solve import multifrontal as mf

    a = grids.poisson_2d(4, dtype=torch.float64, device="cpu")
    sym = mf.analyze(a)
    stack = np.stack([a.data.numpy()] * 2)
    if torch.cuda.is_available():
        assert mf.factor_batched(stack, sym).device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            mf.factor_batched(stack, sym)
    assert mf.factor_batched(stack, sym, device="cpu").device.type == "cpu"


def test_host_library_without_gxx_raises(monkeypatch, tmp_path):
    """No g++ on PATH: the host library cannot be built, and the orderings
    and the symbolic analysis raise a clear RuntimeError (no fall-back to
    the Python engine)."""
    from sparse_linear_tpu_torch.solve import multifrontal as mf
    from sparse_linear_tpu_torch.utils import native

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libslt_host_missing.so")
    native.load.cache_clear()
    try:
        a = grids.poisson_2d(4, dtype=torch.float64, device="cpu")
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            mf.analyze(a, ordering="amd")
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            mf.analyze(a, ordering="natural")
        # the plain engine only when asked for
        assert mf.analyze(a, ordering="natural", engine="python").n == 16
    finally:
        native.load.cache_clear()


def test_host_library_build_failure_raises(monkeypatch, tmp_path):
    from sparse_linear_tpu_torch.utils import native

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "sources", lambda: [bad])
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "libslt_host_broken.so")
    native.load.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            native.native_amd(3, np.array([0, 0, 0, 0]), np.array([]))
        assert not (tmp_path / "libslt_host_broken.so").exists()
    finally:
        native.load.cache_clear()
