"""The port's device multifrontal engine against the JAX package's.

Both engines take the same AMD ordering and the same amalgamation, so their
plans must be equal table for table. The port gives every scatter buffer a
sentinel slot one past its end where the JAX package drops out-of-range
slots: a JAX index at or past the end is compared as the sentinel. Factors
are held to rtol 1e-12 (atol 1e-12 of the tensor's largest entry), the
growth to rtol 1e-10, the solutions to rtol 1e-10 of the JAX solution, and
the residuals against scipy to 1e-10. Every JAX engine is built once per
module (its factor and solve compile once per pattern)."""

import warnings
from dataclasses import replace

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from hpclinalg.solver import device_mf as jdm
from hpclinalg_torch.backend import numpy_dtype
from hpclinalg_torch.cache import plan_cache
from hpclinalg_torch.solver import device_mf as tdm

torch.set_num_threads(1)


def laplace2d(k):
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(k, k))
    I = sp.eye(k)
    return (sp.kron(I, T) + sp.kron(T, I)).tocsr()


def _rel_res(A, x, b):
    return np.linalg.norm(A @ x - b) / np.linalg.norm(b)


def _rhs(n, dtype=np.float64, k=None, seed=11):
    rng = np.random.default_rng(seed)
    shape = (n,) if k is None else (n, k)
    b = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        b = b + 1j * rng.standard_normal(shape)
    return b.astype(dtype)


# name -> (matrix, kind, shards, row partition)
CASES = {
    # n = 256 on 4 shards: a real top set, so the cross reduction and the
    # replicated top levels run
    "chol_top": (lambda: laplace2d(16), "chol", 4, None),
    "chol_serial": (lambda: laplace2d(10), "chol", 1, None),
    # indefinite (2.7 is not an eigenvalue of laplace2d(6))
    "ldl_indefinite": (lambda: (laplace2d(6) - 2.7 * sp.eye(36)).tocsr(),
                       "ldl", 4, None),
    # multi-root forest (-4.6 is not an eigenvalue of laplace2d(4))
    "ldl_blockdiag": (lambda: sp.block_diag([
        laplace2d(4) - 4.6 * sp.eye(16), laplace2d(7)]).tocsr(), "ldl", 4,
        None),
    "lu": (lambda: (laplace2d(7) + sp.random(
        49, 49, 0.05, random_state=np.random.default_rng(105))).tocsr(),
        "lu", 4, None),
    "ldl_complex": (lambda: (laplace2d(6).astype(np.complex128)
                             + 0.4j * sp.eye(36)).tocsr(), "ldl", 4, None),
    "ldl_asym_partition": (lambda: laplace2d(6), "ldl", 4,
                           np.array([0, 3, 20, 30, 36])),
}


class Pair:
    """One case built through both packages from the same inputs."""

    def __init__(self, name):
        make, kind, S, rp = CASES[name]
        self.name, self.kind, self.S = name, kind, S
        self.A = make()
        self.dtype = np.dtype(self.A.dtype)
        self.bej = hl.backend_auto(nshards=S, dtype=self.dtype)
        self.bet = ht.backend_auto(S, dtype=self.dtype, device="cpu")
        self.Aj = hl.DistSparseMatrix.from_scipy(self.A, self.bej,
                                                 row_partition=rp,
                                                 dtype=self.dtype)
        self.At = ht.from_reference(self.bet, self.Aj)
        assert self.At.hash == self.Aj.hash
        self.Fj = jdm.DeviceFactorization(self.Aj, kind=kind)
        self.Ft = tdm.DeviceFactorization(self.At, kind=kind)


_pairs: dict = {}


def _pair(name):
    """Each case is built once per module, for every test that uses it."""
    if name not in _pairs:
        _pairs[name] = Pair(name)
    return _pairs[name]


@pytest.fixture(params=sorted(CASES))
def pair(request):
    return _pair(request.param)


def _table(p, jt, sentinel=None):
    j = np.asarray(jt).astype(np.int64)
    if sentinel is not None:
        j = np.where(j >= sentinel, sentinel, j)
    got = p.cpu().numpy()
    assert got.shape == j.shape
    np.testing.assert_array_equal(got, j)


def test_plan_tables(pair):
    ej, et = pair.Fj.engine, pair.Ft.engine
    bj = ej._bufs
    np.testing.assert_array_equal(et.owner, ej.owner)
    for attr in ("CROSS", "TOPM", "Mmax", "SVPAD", "nnzA", "n_topcols"):
        assert getattr(et, attr) == getattr(ej, attr), attr
    np.testing.assert_array_equal(et.Ms, ej.Ms)
    assert len(et.local_levels) == len(ej.local_levels)
    assert len(et.top_levels) == len(ej.top_levels)
    for mt, mj in zip(et.local_levels + et.top_levels,
                      ej.local_levels + ej.top_levels):
        assert (mt.B, mt.NC, mt.NF) == (mj.B, mj.NC, mj.NF)
        BNN = mt.B * mt.NF * mt.NF
        _table(mt.a_src, bj[mj.a_src])
        _table(mt.a_dst, bj[mj.a_dst], BNN)
        _table(mt.diag, bj[mj.diag], BNN)
        _table(mt.ccol, bj[mj.ccol])
        _table(mt.crow, bj[mj.crow])
        # the solve's scatter-add table: crow flattened over the shards,
        # its padding (masked to zero) spread over real slots
        crow, live = mt.crow.numpy(), mt.crow_live.numpy()[..., 0]
        local = crow.ndim == 3
        sentinel = et.SVPAD if local else et.TOPM
        base = (np.arange(crow.shape[0])[:, None, None] * (sentinel + 1)
                if local else 0)
        add = mt.crow_add.numpy().reshape(crow.shape)
        np.testing.assert_array_equal(live, crow != sentinel)
        np.testing.assert_array_equal(add[live], (crow + base)[live])
        assert ((add - base)[~live] < sentinel).all()
        assert len(mt.ea) == len(mj.ea)
        for et_, ej_ in zip(mt.ea, mj.ea):
            assert et_[0] == ej_[0]
            for a, h in zip(et_[1:], ej_[1:]):
                _table(a, bj[h])
        assert len(mt.ea_cross) == len(mj.ea_cross)
        for et_, ej_ in zip(mt.ea_cross, mj.ea_cross):
            assert et_[4] == ej_[4]
            for a, h in zip(et_[:4], ej_[:4]):
                _table(a, bj[h])
    assert len(et.cross_maps) == len(ej.cross_maps)
    for ct, cj in zip(et.cross_maps, ej.cross_maps):
        assert ct[0] == cj[0]
        for a, h in zip(ct[1:], cj[1:]):
            _table(a, bj[h])
    _table(et.topcols, bj[ej.topcols])
    # the RHS gather and the solution scatter move the same slots
    rng = np.random.default_rng(3)
    for pt, pj, L in ((et.in_plan, ej.in_plan, pair.Aj.structure.Lrow),
                      (et.out_plan, ej.out_plan, ej.SVPAD + 1)):
        x = rng.standard_normal((pair.S, L, 2))
        want = np.asarray(pj.apply(jax.device_put(x, pair.bej.row_sharding(1))))
        np.testing.assert_array_equal(pt.apply(torch.from_numpy(x)).numpy(),
                                      want)


def test_factors(pair):
    Fj, Ft = pair.Fj, pair.Ft
    assert all(x.device.type == "cpu"
               for fac in Ft.factors[0] + Ft.factors[1] for x in fac)
    for facs_t, facs_j in ((Ft.factors[0], Fj.factors[0]),
                           (Ft.factors[1], Fj.factors[1])):
        assert len(facs_t) == len(facs_j)
        for ft, fj in zip(facs_t, facs_j):
            assert len(ft) == len(fj)
            for a, b in zip(ft, fj):
                b = np.asarray(b)
                assert tuple(a.shape) == b.shape
                assert numpy_dtype(a.dtype) == b.dtype
                if b.size:
                    np.testing.assert_allclose(
                        a.numpy(), b, rtol=1e-12,
                        atol=1e-12 * np.abs(b).max())
    assert Ft.n_perturbed == Fj.n_perturbed
    assert Ft.growth == pytest.approx(Fj.growth, rel=1e-10)
    assert Ft._unstable == Fj._unstable


def test_solution(pair):
    A, n = pair.A, pair.A.shape[0]
    b = _rhs(n, pair.dtype)
    xj = pair.Fj.solve(hl.DistVector.from_global(b, pair.bej,
                                                 dtype=pair.dtype))
    bt = ht.DistVector.from_global(b, pair.bet, dtype=pair.dtype)
    x = pair.Ft.solve(bt)
    assert isinstance(x, ht.DistVector) and x.dtype == bt.dtype
    assert np.array_equal(x.partition, pair.At.row_partition)
    xt = x.to_numpy()
    xjn = xj.to_numpy()
    np.testing.assert_allclose(xt, xjn, rtol=1e-10,
                               atol=1e-10 * np.abs(xjn).max())
    assert _rel_res(A, xt, b) <= 1e-10
    # host array in, host array out; and the engine's replicated-RHS solve
    # (no refinement)
    np.testing.assert_allclose(pair.Ft.solve(b), xt, rtol=1e-12)
    xe = pair.Ft.engine.solve(pair.Ft.factors, torch.from_numpy(b))
    np.testing.assert_allclose(xe.numpy(), xt, rtol=1e-10,
                               atol=1e-10 * np.abs(xt).max())
    if pair.kind == "lu":
        xtt = pair.Ft.solve(bt, transpose=True).to_numpy()
        xjt = pair.Fj.solve(hl.DistVector.from_global(b, pair.bej),
                            transpose=True).to_numpy()
        np.testing.assert_allclose(xtt, xjt, rtol=1e-10,
                                   atol=1e-10 * np.abs(xjt).max())
        assert _rel_res(A.T, xtt, b) <= 1e-10


def test_distributed_top_tree():
    p = _pair("chol_top")
    owner = p.Ft.engine.owner
    assert (owner < 0).sum() > 0 and (owner >= 0).sum() > 0
    assert p.Ft.engine.TOPM > 0 and p.Ft.engine.cross_maps


@pytest.mark.parametrize("name", ["ldl_indefinite", "lu"])
def test_multi_rhs(name):
    p = _pair(name)
    n = p.A.shape[0]
    B = _rhs(n, k=6, seed=106)
    Xj = p.Fj.solve_matrix(hl.DistDenseMatrix.from_global(B, p.bej))
    Bt = ht.DistDenseMatrix.from_global(B, p.bet)
    X = p.Ft.solve_matrix(Bt)
    assert isinstance(X, ht.DistDenseMatrix)
    assert np.array_equal(X.row_partition, p.At.row_partition)
    Xt = X.to_numpy()
    np.testing.assert_allclose(Xt, Xj.to_numpy(), rtol=1e-10,
                               atol=1e-10 * np.abs(Xt).max())
    assert np.linalg.norm(p.A @ Xt - B) / np.linalg.norm(B) <= 1e-10
    # host array in, host array out; the transposed sweep
    np.testing.assert_allclose(p.Ft.solve_matrix(B), Xt, rtol=1e-12)
    XT = p.Ft.solve_matrix(B, transpose=True)
    assert np.linalg.norm(p.A.T @ XT - B) / np.linalg.norm(B) <= 1e-10


@pytest.mark.parametrize("name", ["chol_top", "lu"])
def test_refactorize(name):
    """Same pattern, new values: the engine (plan) is reused, the factors
    are recomputed, and both packages agree again."""
    p = _pair(name)
    Fj = jdm.DeviceFactorization(p.Aj, kind=p.kind)
    Ft = tdm.DeviceFactorization(p.At, kind=p.kind)
    assert Ft.engine is p.Ft.engine
    Fj.refactorize(p.Aj * 3.0)
    assert Ft.refactorize(p.At * 3.0) is Ft
    for ft, fj in zip(Ft.factors[0] + Ft.factors[1],
                      Fj.factors[0] + Fj.factors[1]):
        for a, b in zip(ft, fj):
            b = np.asarray(b)
            if b.size:
                np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                           atol=1e-12 * np.abs(b).max())
    b = _rhs(p.A.shape[0])
    x = Ft.solve(b)
    assert _rel_res(3.0 * p.A, x, b) <= 1e-10
    np.testing.assert_allclose(x, Fj.solve(b), rtol=1e-10,
                               atol=1e-10 * np.abs(x).max())
    other = ht.DistSparseMatrix.from_scipy(laplace2d(5), p.bet)
    with pytest.raises(ValueError):
        Ft.refactorize(other)
    Ft.finalize()
    with pytest.raises(RuntimeError, match="finalized"):
        Ft.solve(b)


@pytest.mark.parametrize("case", ["indefinite", "blockdiag"])
def test_spd_rejects_non_spd(case):
    """spd=True raises on an indefinite matrix, and on a non-SPD component
    of a block-diagonal matrix whose root finishes below the last level."""
    be = ht.backend_auto(4, device="cpu")
    if case == "indefinite":
        A = laplace2d(8).tolil()
        A[10, 10] = -50.0
    else:
        A = sp.block_diag([(laplace2d(4) - 5 * sp.eye(16)), laplace2d(7)])
    Ad = ht.DistSparseMatrix.from_scipy(A.tocsr(), be)
    with pytest.raises(ValueError, match="SPD"):
        ht.ldlt(Ad, method="device", spd=True)
    if case == "indefinite":
        # the LDL kernel takes the same matrix (laplace2d(4) - 5 I of the
        # other case is singular: 5 is an eigenvalue)
        F = ht.ldlt(Ad, method="device")
        b = _rhs(A.shape[0])
        assert _rel_res(A.tocsr(), F.solve(b), b) <= 1e-10


def test_chol_rejects_complex():
    be = ht.backend_auto(4, dtype=np.complex128, device="cpu")
    A = (laplace2d(6).astype(np.complex128) + 0.4j * sp.eye(36)).tocsr()
    Ad = ht.DistSparseMatrix.from_scipy(A, be)
    with pytest.raises(ValueError, match="real-SPD"):
        ht.ldlt(Ad, method="device", spd=True)


def test_chain_tree_falls_back_to_host():
    """A banded pattern serializes the wave schedule: the device dispatch
    warns and takes the host engine; the engine itself raises its typed
    error."""
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(4000, 4000)).tocsr()
    be = ht.backend_auto(4, device="cpu")
    Ad = ht.DistSparseMatrix.from_scipy(T, be)
    with pytest.warns(UserWarning, match="host"):
        F = ht.ldlt(Ad, method="device")
    assert isinstance(F, ht.Factorization)
    b = _rhs(4000)
    x = F.solve(ht.DistVector.from_global(b, be))
    assert _rel_res(T, x.to_numpy(), b) < 1e-10
    with pytest.raises(tdm.DeviceScheduleError, match="host"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            tdm.DeviceFactorization(Ad, kind="ldl")
    with pytest.warns(UserWarning, match="host"):
        assert isinstance(ht.lu(Ad, method="device"), ht.Factorization)


def test_device_solver_routing():
    """A backend built with solver='device' routes ldlt/lu/solve to the
    device engine; new values on the same pattern are a refactorize-only
    hit of the backslash cache. from_reference carries the JAX backend's
    solver over."""
    A = laplace2d(6)
    b = _rhs(36)
    bej = replace(hl.backend_auto(nshards=4), solver="device")
    Aj = hl.DistSparseMatrix.from_scipy(A, bej)
    At = ht.from_reference(ht.backend_auto(4, device="cpu"), Aj)
    assert At.backend.solver == "device"
    assert isinstance(ht.ldlt(At), tdm.DeviceFactorization)
    assert isinstance(ht.lu(At), tdm.DeviceFactorization)
    assert isinstance(ht.ldlt(At, method="host"), ht.Factorization)
    with pytest.raises(ValueError, match="method"):
        ht.ldlt(At, method="gpu")
    ht.clear_plan_cache("backslash")
    bt = ht.DistVector.from_global(b, At.backend)
    x = ht.solve(At, bt).to_numpy()
    xj = hl.solve(Aj, hl.DistVector.from_global(b, bej)).to_numpy()
    np.testing.assert_allclose(x, xj, rtol=1e-10, atol=1e-10 * abs(xj).max())
    assert _rel_res(A, x, b) <= 1e-10
    c = plan_cache("backslash")
    assert len(c) == 1
    F = next(iter(c.values()))
    assert isinstance(F, tdm.DeviceFactorization)
    At2 = At * 2.0
    x2 = ht.solve(At2, bt).to_numpy()
    assert len(c) == 1 and next(iter(c.values())) is F and F.A is At2
    assert _rel_res(2.0 * A, x2, b) <= 1e-10
    # a host backend still takes the host engine, under its own cache key
    Ah = ht.from_reference(ht.backend_auto(4, device="cpu", solver="device"),
                           hl.DistSparseMatrix.from_scipy(A, replace(
                               bej, solver="multifrontal")))
    assert Ah.backend.solver == "multifrontal"
    assert isinstance(ht.ldlt(Ah), ht.Factorization)
    ht.solve(Ah, b)
    assert len(c) == 2
    ht.clear_plan_cache("backslash")
    with pytest.raises(ValueError, match="solver"):
        ht.backend_auto(2, device="cpu", solver="cudss")


def test_growth_monitor_f32():
    """[[1e-4 I, L], [L, 1e-4 I]] is well conditioned, but every early
    pivot is ~1e-4: the unpivoted f32 factor shows |L| growth ~1e4, is
    flagged unstable, and its solve recovers through refinement
    (tests/test_pivoting.py::test_device_growth_monitor, there at k = 20).
    The growth is held to the JAX engine's in f32 to rtol 1e-3: the two
    factor in f32 arithmetic in different operation orders."""
    k = 10
    L = laplace2d(k)
    n = 2 * k * k
    A = sp.bmat([[1e-4 * sp.eye(k * k), L], [L, 1e-4 * sp.eye(k * k)]],
                format="csr").astype(np.float32)
    Aj = hl.DistSparseMatrix.from_scipy(
        A, hl.backend_auto(nshards=4, dtype=np.float32), dtype=np.float32)
    At = ht.from_reference(ht.backend_auto(4, dtype=np.float32,
                                           device="cpu"), Aj)
    F = tdm.DeviceFactorization(At, kind="ldl")
    assert F.engine.dtype == torch.float32
    assert F.growth > 1e3
    assert F._unstable == (F.n_perturbed > 0 or F.growth > 1e4)
    Fj = jdm.DeviceFactorization(Aj, kind="ldl", dtype=np.float32)
    assert F.growth == pytest.approx(Fj.growth, rel=1e-3)
    assert F.n_perturbed == Fj.n_perturbed
    b = _rhs(n).astype(np.float32)
    x = F.solve(b)
    r = np.linalg.norm(A.astype(np.float64) @ np.asarray(x, np.float64) - b) \
        / np.linalg.norm(b)
    assert r < 1e-4, r


def test_extended_refinement_f32():
    """An f32 factorization refined with f64 residuals reaches a 1e-9
    relative residual (tests/test_factorization.py::
    test_extended_refinement_f32 asks the same of the JAX package), well
    ahead of plain f32 refinement. A host-array RHS gets the f64 solution;
    a DistVector RHS gets a DistVector in its own dtype."""
    be = ht.backend_auto(4, dtype=np.float32, device="cpu")
    k = 64
    L = laplace2d(k).astype(np.float32)
    n = k * k
    Ad = ht.DistSparseMatrix.from_scipy(L, be, dtype=np.float32)
    b = np.random.default_rng(5).standard_normal(n).astype(np.float32)
    F = tdm.DeviceFactorization(Ad, kind="chol")
    assert F.engine.dtype == torch.float32
    x = F.solve(b, extended=True)
    assert x.dtype == np.float64
    resid = _rel_res(L.astype(np.float64), x, b)
    assert resid < 1e-9, resid
    xp = F.solve(b, extended=False)
    resid_p = _rel_res(L.astype(np.float64), np.asarray(xp, np.float64), b)
    assert resid < resid_p / 50
    bd = ht.DistVector.from_global(b, be, dtype=np.float32)
    xd = F.solve(bd)   # extended by default on an f32 engine
    assert xd.dtype == torch.float32
    np.testing.assert_allclose(xd.to_numpy(), x, rtol=1e-6,
                               atol=1e-6 * np.abs(x).max())


def test_upper_triangle_never_read():
    """Symmetric fronts are assembled in the lower triangle only: the
    front kernels give the same factors whatever the upper triangle holds."""
    rng = np.random.default_rng(9)
    M = rng.standard_normal((3, 2, 9, 9))
    F = torch.from_numpy(M @ np.swapaxes(M, -1, -2) + 9 * np.eye(9))
    junk = torch.triu(torch.from_numpy(rng.standard_normal((3, 2, 9, 9))), 1)
    for kind in ("chol", "ldl"):
        a = tdm._front_kernel(kind, F, 5, 1e-12)
        b = tdm._front_kernel(kind, torch.tril(F) + junk, 5, 1e-12)
        for x, y in zip(a[0], b[0]):
            torch.testing.assert_close(x, y, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("kind,n", [("ldl", 11), ("lu", 11), ("ldl", 33),
                                    ("lu", 33), ("ldl", 65), ("lu", 65)],
                         ids=["ldl", "lu", "ldl-33", "lu-33", "ldl-65",
                              "lu-65"])
def test_batched_kernels_match_jax(kind, n):
    """batched_ldl / batched_lu on one batch, with pivots below eps so the
    static-pivot clamp fires, against the JAX package's kernels; at 33 and
    65 columns the splits above the card's leaf size (``cuda_ldl.LEAF``)
    are held too. There the batch is diagonally dominant, with alternating
    signs, and the tiny pivots' rows and columns are zero: a clamped pivot
    coupled to the rest grows L to about 1e10, and the complements after it
    are then cancellations that no two orders of summation agree on."""
    rng = np.random.default_rng(21)
    F = rng.standard_normal((4, n, n))
    if kind == "ldl":
        F = F + np.swapaxes(F, 1, 2)
    if n > 11:
        F = F + 3 * n * np.diag(np.where(np.arange(n) % 2, -1.0, 1.0))
        F[:, 0, 1:] = 0.0
        F[:, 1:, 0] = 0.0
    F[:, 0, 0] = 1e-14
    F[1, 3, :] = 0.0
    F[1, :, 3] = 0.0
    eps = 1e-10
    got = getattr(tdm, f"batched_{kind}")(torch.from_numpy(F), eps)
    want = getattr(jdm, f"batched_{kind}")(jax.numpy.asarray(F), eps)
    for a, b in zip(got[:2], want[:2]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-12,
                                   atol=1e-12 * np.abs(b).max())
    assert int(got[2]) == int(want[2]) >= 4
