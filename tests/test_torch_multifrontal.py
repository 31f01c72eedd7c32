"""The port's multifrontal direct solver against the JAX package, on the CPU.

The same numpy inputs go through ``sparse_linear_tpu.solve.multifrontal``
(x64 on the CPU) and ``sparse_linear_tpu_torch.solve.multifrontal``
(``device="cpu"``):

* the host schedule (buckets, index maps, pattern key) must be identical;
* factor blocks agree within 1e-12 relative in f64 and 1e-5 in f32, the
  local LU permutations exactly (an operator without pivot ties);
* solutions within 1e-12 relative with residuals <= 1e-12, and the port's
  solves on the JAX package's own factors (carried across as numpy arrays
  by ``interop.jax_state``) within 1e-13;
* the queries (slogdet, rcond, get_factors, lunz), partial solves, batched
  factors, equilibration, static pivoting and the failure reports match.

Every operator shares the 8**2 five-point pattern (or a perturbed copy of
its values), so the JAX package compiles few programs.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import sparse_linear_tpu as sl  # noqa: E402
from sparse_linear_tpu.solve import multifrontal as jmf  # noqa: E402
from sparse_linear_tpu.ops.build import trim  # noqa: E402
from sparse_linear_tpu.utils.grids import laplacian_1d, poisson_2d  # noqa: E402
from sparse_linear_tpu_torch.interop import jax_state  # noqa: E402
from sparse_linear_tpu_torch.solve import api  # noqa: E402
from sparse_linear_tpu_torch.solve import multifrontal as mf  # noqa: E402
from spbench.operators import mesh2d  # noqa: E402
from tests.torch_parity import np_of, permuted_poisson, to_port  # noqa: E402

G = 8
N = G * G
DENSE = np.asarray(poisson_2d(G, dtype=np.float64).todense())
NZ = (DENSE != 0) & ~np.eye(N, dtype=bool)


def _values(case):
    """Dense matrix of a named case on the Poisson pattern: "spd" (the
    operator), "hpd" (plus i times an antisymmetric part: Hermitian
    positive definite), "unsym" (perturbed off-diagonals, diagonally
    dominant), "cunsym" (its complex version), "pivot" and "cpivot"
    (random values with a weak diagonal: row exchanges inside the pivot
    blocks, and no ties)."""
    rng = np.random.default_rng(5)
    pert = rng.uniform(-0.4, 0.4, DENSE.shape) * NZ
    if case == "spd":
        return DENSE.copy()
    if case == "hpd":
        return DENSE + 1j * 0.3 * (pert - pert.T)
    if case == "unsym":
        return DENSE + pert
    if case == "cunsym":
        return DENSE + pert + 1j * rng.uniform(-0.4, 0.4, DENSE.shape) * NZ
    weak = np.diag(rng.uniform(0.2, 0.6, N)) + rng.uniform(-2, 2,
                                                           DENSE.shape) * NZ
    if case == "pivot":
        return weak
    if case == "cpivot":
        return weak + 1j * rng.uniform(-1, 1, DENSE.shape) * NZ
    raise ValueError(case)


_CACHE = {}


def _dtype(case, dtype):
    if dtype is None:
        return (np.complex128 if case in ("hpd", "cunsym", "cpivot")
                else np.float64)
    return dtype


def _pair(case, dtype=None):
    """(JAX matrix, port matrix) of a case, with the Poisson pattern."""
    dtype = _dtype(case, dtype)
    key = ("pair", case, np.dtype(dtype).name)
    if key not in _CACHE:
        d = _values(case).astype(dtype)
        rows, cols = np.nonzero(NZ | np.eye(N, dtype=bool))
        ja = trim(sl.from_triples((N, N), rows, cols, d[rows, cols]).tocsr())
        _CACHE[key] = (ja, to_port(ja))
    return _CACHE[key]


def _symbolics(case="spd", dtype=None, **opts):
    dtype = _dtype(case, dtype)
    key = ("sym", case, np.dtype(dtype).name, tuple(sorted(opts.items())))
    if key not in _CACHE:
        ja, a = _pair(case, dtype)
        _CACHE[key] = (jmf.analyze(ja, **opts), mf.analyze(a, **opts))
    return _CACHE[key]


def _factors(case, dtype=None, kind="lu", **fopts):
    dtype = _dtype(case, dtype)
    key = ("fac", case, np.dtype(dtype).name, kind,
           tuple(sorted(fopts.items())))
    if key not in _CACHE:
        ja, a = _pair(case, dtype)
        js, s = _symbolics(case, dtype, dims=(G, G))
        _CACHE[key] = (jmf.factor(ja, js, kind=kind, **fopts),
                       mf.factor(a, s, kind=kind, **fopts))
    return _CACHE[key]


def _rhs(k, cplx, seed=3):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((N, k))
    if cplx:
        b = b + 1j * rng.standard_normal((N, k))
    return b[:, 0] if k == 1 else b


def _rel(x, ref):
    return np.abs(x - ref).max() / max(np.abs(ref).max(), 1e-300)


def jax_mf_arrays(jf):
    """The ``"mf_factors"`` leaves (numpy) of a JAX-package MFFactors."""
    arrays = {f"{name}.{bidx}": np.asarray(blk[name])
              for bidx, blk in jf.blocks.items() if bidx >= 0
              for name in jax_state.MF_BLOCK_LEAVES}
    arrays.update(n_flag=np.asarray(jf.blocks[-1]["n_flag"]), kind=jf.kind,
                  batch=getattr(jf, "batch", None))
    if -2 in jf.blocks:
        arrays["rscale"] = np.asarray(jf.blocks[-2]["rscale"])
    return arrays


# ------------------------------------------------------------- schedule


def _assert_same_schedule(s, js):
    """Bucket for bucket, map for map."""
    np.testing.assert_array_equal(s.perm, js.perm)
    assert s.pattern_key == js.pattern_key
    assert s.relax == js.relax
    for key in ("height", "nsuper", "level_buckets"):
        assert s.schedule[key] == js.schedule[key], key
    np.testing.assert_array_equal(s.entry_rows, js.entry_rows)
    np.testing.assert_array_equal(s.entry_cols, js.entry_cols)
    assert len(s.schedule["flat"]) == len(js.schedule["flat"])
    for b, jb in zip(s.schedule["flat"], js.schedule["flat"]):
        for key in ("level", "Ns", "Us", "sup_ids", "rows_piv", "rows_upd",
                    "ns_real"):
            np.testing.assert_array_equal(b[key], jb[key], err_msg=key)
        assert b["children"].keys() == jb["children"].keys()
        for cb, g in b["children"].items():
            for key in ("cslot", "pslot", "maps"):
                np.testing.assert_array_equal(g[key], jb["children"][cb][key])
    for bidx, am in s.a_entry_maps.items():
        for key in ("src", "slot", "r", "c"):
            np.testing.assert_array_equal(am[key], js.a_entry_maps[bidx][key])


def _sup_start(sym):
    """First column of every supernode, from the buckets' pivot counts."""
    nc = np.zeros(sym.schedule["nsuper"], np.int64)
    for b in sym.schedule["flat"]:
        nc[b["sup_ids"]] = b["ns_real"]
    return np.concatenate([[0], np.cumsum(nc)])


ORDERINGS = {"natural": {"ordering": "natural"}, "rcm": {"ordering": "rcm"},
             "nd_grid": {"dims": (10, 10)}, "amd": {"ordering": "amd"},
             "nd_general": {"ordering": "nd"}}


@pytest.mark.parametrize("name", sorted(ORDERINGS))
def test_schedule_identical(name):
    """Bucket for bucket, map for map: the same schedule as the JAX
    package's analyze, on a pattern with no structure to find."""
    ja = permuted_poisson(10, np.float64)
    a = to_port(ja)
    js = jmf.analyze(ja, **ORDERINGS[name])
    s = mf.analyze(a, **ORDERINGS[name])
    _assert_same_schedule(s, js)


def test_mesh_schedule_identical():
    """A few-thousand-node mesh of ``fem2d-newmesh-f64``, no dims: the
    port's AMD on its native symmetrized pattern gives the JAX package's
    perm, supernodes and schedule."""
    cfg = json.loads((Path(__file__).resolve().parent.parent / "spbench"
                      / "configs" / "fem2d-newmesh-f64.json").read_text())
    m = mesh2d.mesh(3000, cfg["aspect"], cfg["jitter"],
                    torch.Generator().manual_seed(3), "cpu")
    rows, cols, vals = (t.numpy() for t in mesh2d.triples(m))
    ja = trim(sl.from_triples((m.n, m.n), rows, cols, vals).tocsr())
    js = jmf.analyze(ja)
    s = mf.analyze(to_port(ja))
    np.testing.assert_array_equal(_sup_start(s), _sup_start(js))
    _assert_same_schedule(s, js)


def test_python_engine_gives_the_same_schedule():
    ja, a = _pair("spd")
    s_nat = mf.analyze(a, ordering="amd")
    s_py = mf.analyze(a, ordering="amd", engine="python")
    for b, pb in zip(s_nat.schedule["flat"], s_py.schedule["flat"]):
        for key in ("Ns", "Us", "sup_ids", "rows_piv", "rows_upd"):
            np.testing.assert_array_equal(b[key], pb[key])
    with pytest.raises(ValueError, match="engine"):
        mf.analyze(a, engine="fortran")


def test_symbolic_carried_across_gives_the_same_schedule():
    """``mf_symbolic`` carries perm and relax; the port re-derives the
    identical schedule with analyze(perm=...)."""
    ja = permuted_poisson(10, np.float64)
    js = jmf.analyze(ja, ordering="amd", relax_small=4, relax_frac=0.1)
    s = jax_state.from_arrays(
        "mf_symbolic", {"perm": js.perm, "relax": js.relax}, (100, 100),
        mat=to_port(ja))
    np.testing.assert_array_equal(s.perm, js.perm)
    assert s.relax == (4, 0.1)
    for b, jb in zip(s.schedule["flat"], js.schedule["flat"]):
        np.testing.assert_array_equal(b["rows_upd"], jb["rows_upd"])
    kind, arrays, shape, _ = jax_state.to_arrays(s)
    assert kind == "mf_symbolic" and shape == (100, 100)
    np.testing.assert_array_equal(arrays["perm"], js.perm)


# ------------------------------------------------------------ factors


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)],
                         ids=["f64", "f32"])
def test_cholesky_blocks(dtype, tol):
    jf, f = _factors("spd", dtype, kind="cholesky")
    for bidx in range(len(f.symbolic.schedule["flat"])):
        for name in ("lu", "g12", "g21"):
            got, want = np_of(f.blocks[bidx][name]), np.asarray(
                jf.blocks[bidx][name])
            assert got.shape == want.shape and got.dtype == want.dtype
            assert np.abs(got - want).max() <= tol * np.abs(want).max(), (
                bidx, name)
    assert f.n_flagged == 0 and not f.breakdown


@pytest.mark.parametrize("case", ["unsym", "pivot", "cpivot"])
def test_lu_blocks_and_local_permutations(case):
    """Equal local permutations: none needed on the diagonally dominant
    operator, row exchanges inside the pivot blocks on the weak-diagonal
    ones (random values, so no ties)."""
    jf, f = _factors(case)
    for bidx in range(len(f.symbolic.schedule["flat"])):
        np.testing.assert_array_equal(np_of(f.blocks[bidx]["perm"]),
                                      np.asarray(jf.blocks[bidx]["perm"]))
        for name in ("lu", "g12", "g21"):
            got, want = np_of(f.blocks[bidx][name]), np.asarray(
                jf.blocks[bidx][name])
            assert _rel(got, want) <= 1e-12, (bidx, name)
    exchanged = any((np_of(f.blocks[b]["perm"]) != np.arange(
        f.blocks[b]["perm"].shape[-1])).any()
        for b in range(len(f.symbolic.schedule["flat"])))
    assert exchanged == (case != "unsym")


SOLVE_CASES = {("lu", "f64"): "unsym", ("lu", "c128"): "cunsym",
               ("cholesky", "f64"): "spd", ("cholesky", "c128"): "hpd"}


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("trans", ["N", "H", "T"])
@pytest.mark.parametrize("dtype", ["f64", "c128"])
@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_solve_equal_jax(kind, dtype, trans, k):
    case = SOLVE_CASES[(kind, dtype)]
    jf, f = _factors(case, kind=kind)
    from sparse_linear_tpu.solve import api as japi

    b = _rhs(k, dtype == "c128")
    x = np_of(api.solve(f, torch.as_tensor(b), trans=trans))
    want = np.asarray(japi.solve(jf, jnp.asarray(b), trans=trans))
    assert x.shape == b.shape
    assert _rel(x, want) <= 1e-12
    d = _values(case)
    op = {"N": d, "H": d.conj().T, "T": d.T}[trans]
    assert np.linalg.norm(op @ x - b) / np.linalg.norm(b) <= 1e-12


@pytest.mark.parametrize("dtype", ["f64", "c128"])
@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_port_solves_on_jax_factors(kind, dtype):
    """The JAX package's factors, carried across as numpy arrays, solved
    by the port: equal to the JAX package's own solve within 1e-13."""
    jf, _ = _factors(SOLVE_CASES[(kind, dtype)], kind=kind)
    js, _ = _symbolics(SOLVE_CASES[(kind, dtype)], dims=(G, G))
    ps = jax_state.from_arrays("mf_symbolic",
                               {"perm": js.perm, "relax": js.relax},
                               (N, N), mat=_pair(SOLVE_CASES[(kind, dtype)])[1])
    pf = jax_state.from_arrays("mf_factors", jax_mf_arrays(jf), (N, N),
                               symbolic=ps, device="cpu")
    assert pf.kind == kind and pf.batch is None
    b = _rhs(5, dtype == "c128")
    for trans in (False, True):
        got = np_of(mf.solve(pf, torch.as_tensor(b), trans=trans))
        want = np.asarray(jmf.solve(jf, jnp.asarray(b), trans=trans))
        assert _rel(got, want) <= 1e-13


def test_factors_round_trip_and_move():
    _, f = _factors("hpd", kind="cholesky")
    kind, arrays, shape, _ = jax_state.to_arrays(f)
    assert kind == "mf_factors" and shape == (N, N)
    back = jax_state.from_arrays(kind, arrays, shape, symbolic=f.symbolic,
                                 device="cpu")
    moved = f.to("cpu")
    b = torch.as_tensor(_rhs(2, True))
    x = mf.solve(f, b)
    assert torch.equal(mf.solve(back, b), x)
    assert torch.equal(mf.solve(moved, b), x)


def test_factor_batched_equal_jax():
    """ne = 3 complex value-sets over one symbolic, solved in both modes."""
    js, s = _symbolics("cunsym", dims=(G, G))
    ja, _ = _pair("cunsym")
    base = np.asarray(ja.data)
    stack = np.stack([base * (1.0 + 0.2 * e) + 0.5j * e * (
        np.asarray(ja.row_ids()) == np.asarray(ja.indices)) for e in range(3)])
    jfb = jmf.factor_batched(jnp.asarray(stack), js)
    fb = mf.factor_batched(torch.as_tensor(stack), s)
    assert fb.batch == 3
    rng = np.random.default_rng(8)
    bs = rng.standard_normal((3, N, 2)) + 1j * rng.standard_normal((3, N, 2))
    for trans in (False, True):
        got = np_of(mf.solve_batched(fb, torch.as_tensor(bs), trans=trans))
        want = np.asarray(jmf.solve_batched(jfb, jnp.asarray(bs),
                                            trans=trans))
        assert _rel(got, want) <= 1e-12
    for e in range(3):
        rows = np.asarray(ja.row_ids())
        d = np.zeros((N, N), complex)
        d[rows, np.asarray(ja.indices)] = stack[e]
        x = np_of(mf.solve_batched(fb, torch.as_tensor(bs)))[e]
        assert np.linalg.norm(d @ x - bs[e]) / np.linalg.norm(bs[e]) < 1e-12
    for got, want in zip(mf.slogdet(fb), jmf.slogdet(jfb)):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(mf.rcond(fb), jmf.rcond(jfb), rtol=1e-12)
    with pytest.raises(ValueError, match="rhs stack"):
        mf.solve_batched(fb, torch.as_tensor(bs[:2]))
    with pytest.raises(ValueError, match="index="):
        mf.get_factors(fb)


@pytest.mark.parametrize("sys", mf._PART_SYS)
def test_solve_part_equal_jax(sys):
    jf, f = _factors("cunsym")
    b = _rhs(3, True)
    got = np_of(mf.solve_part(f, torch.as_tensor(b), sys))
    want = np.asarray(jmf.solve_part(jf, jnp.asarray(b), sys))
    assert _rel(got, want) <= 1e-12
    # and it solves the system it names, over get_factors' export
    L, U, rp, cp = mf.get_factors(f)
    L, U = np_of(L.todense()), np_of(U.todense())
    n = rp.shape[0]
    P, Q = np.eye(n)[rp], np.eye(n)[:, cp]
    op = {"Pt_L": P.T @ L, "L": L, "Lt_P": L.conj().T @ P,
          "Lat_P": L.T @ P, "Lt": L.conj().T, "Lat": L.T, "U_Qt": U @ Q.T,
          "U": U, "Ut_Q": U.conj().T @ Q, "Uat_Q": U.T @ Q,
          "Ut": U.conj().T, "Uat": U.T}[sys]
    assert np.linalg.norm(op @ got - b) / np.linalg.norm(b) <= 1e-12


@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_queries_equal_jax(kind):
    case = "cunsym" if kind == "lu" else "hpd"
    jf, f = _factors(case, kind=kind)
    sign, logabs = mf.slogdet(f)
    jsign, jlogabs = jmf.slogdet(jf)
    np.testing.assert_allclose(logabs, jlogabs, rtol=1e-12)
    np.testing.assert_allclose(sign, jsign, rtol=1e-12, atol=1e-12)
    wsign, wlog = np.linalg.slogdet(_values(case))
    np.testing.assert_allclose(logabs, wlog, rtol=1e-12)
    np.testing.assert_allclose(sign, wsign, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(mf.rcond(f), jmf.rcond(jf), rtol=1e-12)
    L, U, rp, cp = mf.get_factors(f)
    jL, jU, jrp, jcp = jmf.get_factors(jf)
    np.testing.assert_array_equal(cp, jcp)
    np.testing.assert_array_equal(rp, jrp)
    lu_prod = np_of(L.todense()) @ np_of(U.todense())
    d = _values(case)
    assert _rel(lu_prod, d[np.ix_(rp, cp)]) <= 1e-12
    assert _rel(np_of(L.todense()), np.asarray(jL.todense())) <= 1e-12
    assert mf.lunz(f) == jmf.lunz(jf)


@pytest.mark.parametrize("scale", ["sum", "max"])
@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_equilibrated_equal_jax(kind, scale):
    case = "unsym" if kind == "lu" else "spd"
    jf, f = _factors(case, kind=kind, scale=scale)
    np.testing.assert_allclose(np_of(f.row_scale), np.asarray(jf.row_scale),
                               rtol=1e-14)
    b = _rhs(2, False)
    for trans in (False, True):
        got = np_of(mf.solve(f, torch.as_tensor(b), trans=trans))
        want = np.asarray(jmf.solve(jf, jnp.asarray(b), trans=trans))
        assert _rel(got, want) <= 1e-12
    np.testing.assert_allclose(mf.slogdet(f)[1], jmf.slogdet(jf)[1],
                               rtol=1e-12)
    with pytest.raises(ValueError, match="scale mode"):
        mf.factor(_pair(case)[1], f.symbolic, scale="l2")


def _shifted(sigma, g=16):
    """(JAX, port) CSR of poisson_2d(g) - sigma I."""
    a = poisson_2d(g, dtype=np.float64)
    ja = sl.lin(1.0, a, -sigma, sl.eye(g * g, dtype=jnp.float64)).tocsr()
    return ja, to_port(ja)


def test_pivot_eps_count_equal_jax():
    """A singular shift (an exact eigenvalue): the static perturbation fires
    as many times as in the JAX package, and the factors stay finite."""
    g = 16
    lam1 = 2.0 - 2.0 * np.cos(np.arange(1, g + 1) * np.pi / (g + 1))
    ja, a = _shifted(float(lam1[g // 2] * 2.0), g)
    js, s = jmf.analyze(ja, dims=(g, g)), mf.analyze(a, dims=(g, g))
    jf = jmf.factor(ja, js, pivot_eps=1e-8)
    f = mf.factor(a, s, pivot_eps=1e-8)
    assert f.n_flagged > 0
    assert f.n_flagged == jf.n_flagged
    for blk in (b for k, b in f.blocks.items() if k >= 0):
        for t in blk.values():
            assert bool(torch.isfinite(t).all())


def test_cholesky_breakdown_reported():
    g = 12
    ja, a = _shifted(4.0, g)
    js, s = jmf.analyze(ja, dims=(g, g)), mf.analyze(a, dims=(g, g))
    jf = jmf.factor(ja, js, kind="cholesky")
    f = mf.factor(a, s, kind="cholesky")
    assert jf.breakdown and f.breakdown
    assert f.n_flagged > 0
    _, info = api.solve_refined(f, a, torch.ones(g * g, dtype=torch.float64),
                                max_iter=3)
    assert not info.converged
    ok = mf.factor(_pair("spd")[1], _symbolics(dims=(G, G))[1],
                   kind="cholesky")
    assert not ok.breakdown


def test_pattern_mismatch_rejected():
    _, s = _symbolics(dims=(G, G))
    other = to_port(laplacian_1d(N, dtype=np.float64))
    with pytest.raises(ValueError, match="pattern does not match the "
                       "symbolic analysis"):
        mf.factor(other, s)
    with pytest.raises(ValueError, match="rhs has"):
        mf.solve(_factors("spd")[1], torch.ones(N + 1, dtype=torch.float64))


def test_mesh_raises():
    """``mesh=`` is ported (``tests/test_torch_dist.py``): a mesh without
    the batch axis asked for raises, through ``mf.factor`` and through
    ``api.factor``."""
    from sparse_linear_tpu_torch.dist import Mesh

    _, a = _pair("spd")
    _, s = _symbolics(dims=(G, G))
    mesh = Mesh(["cpu"] * 2, ("fronts",))
    with pytest.raises(ValueError, match="no axis 'x'"):
        mf.factor(a, s, mesh=mesh, batch_axis="x")
    with pytest.raises(ValueError, match="no axis 'x'"):
        api.factor(a, s, backend="multifrontal", mesh=mesh, batch_axis="x")


def test_full_f32_under_a_tf32_setting(monkeypatch):
    """A caller's ``set_float32_matmul_precision("high")`` does not reach
    the factor's and the solve's products, and is restored after."""
    _, a = _pair("spd", np.float32)
    _, s = _symbolics("spd", np.float32, dims=(G, G))
    b = torch.as_tensor(_rhs(3, False), dtype=torch.float32)
    ref = mf.solve(mf.factor(a, s, kind="cholesky"), b)
    seen = []
    real_bmm, real_baddbmm = torch.bmm, torch.baddbmm

    def bmm(*args, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return real_bmm(*args, **kw)

    def baddbmm(*args, **kw):
        seen.append(torch.get_float32_matmul_precision())
        return real_baddbmm(*args, **kw)

    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        monkeypatch.setattr(torch, "bmm", bmm)
        monkeypatch.setattr(torch, "baddbmm", baddbmm)
        x = mf.solve(mf.factor(a, s, kind="cholesky"), b)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert seen and set(seen) == {"highest"}
    assert torch.equal(x, ref)


def test_analyze_rejects_bad_input():
    _, a = _pair("spd")
    with pytest.raises(ValueError, match="perm must have shape"):
        mf.analyze(a, perm=np.arange(N - 1))
    with pytest.raises(ValueError, match="unknown ordering"):
        mf.analyze(a, ordering="colamd")
    rect = to_port(sl.from_triples((3, 4), [0, 1], [0, 3], [1.0, 2.0]))
    with pytest.raises(ValueError, match="square"):
        mf.analyze(rect)
