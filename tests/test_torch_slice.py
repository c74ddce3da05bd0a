"""The port's main path as a whole against the JAX package's.

The JAX side runs ``__graft_entry__._cg_step_fn`` (the library's own CG
step). Its matrix and its CG state x, r, p in the middle of an iteration
are handed to the port through ``from_reference`` as numpy arrays; both
then take 20 more steps in f64 and must agree to rtol 1e-9 (CG amplifies
last-bit differences in the reductions a little each step). The port's
step uses only the public API. Then ``ldlt(A).solve(b)`` of both agree to
1e-10.

The second path is the sparse ridge regression of ``chip_smoke.py`` cut to
m = 20,000 observations and n = 512 unknowns, from the same generator:
At = A.T.materialize(), N = (At @ A).add_identity(lambda), rhs = At @ b, CG
on N, ldlt(N).solve(rhs) and A @ x, through both packages and scipy.

The third is the multi-response ridge of ``chip_smoke.py`` phase 8 at the
same cut size with eight responses: R = At @ Y, Xh = solve(N, R), N @ Xh,
Xh.T @ Xh and A @ Xh - Y."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg.ops.spmv as jspmv
import hpclinalg_torch as ht
import hpclinalg_torch.ops.cuda_ell_resident as tk3
import hpclinalg_torch.ops.spmv as tspmv
from __graft_entry__ import _cg_step_fn, _laplace2d
from chip_smoke import RIDGE_CG_RTOL, RIDGE_LAMBDA, banded_design

torch.set_num_threads(1)


def cg_step(A, x, r, p):
    """One CG iteration with the port's public API."""
    Ap = A @ p
    rr = r.dot(r)
    alpha = rr / p.dot(Ap)
    x = x + alpha * p
    r2 = r - alpha * Ap
    p2 = r2 + (r2.dot(r2) / rr) * p
    return x, r2, p2


def _matrix_state(Aj):
    st = Aj.structure
    return dict(nzval=np.asarray(Aj.nzval), indptr=st.indptr,
                colval=st.colval, col_indices=st.col_indices,
                row_partition=st.row_partition,
                col_partition=st.col_partition, ncols=Aj.ncols)


@pytest.mark.parametrize("S", [1, 4])
def test_cg_then_solve_matches_reference(S):
    k = 24
    A = _laplace2d(k, np.float64)
    n = A.shape[0]
    bh = np.random.default_rng(S).standard_normal(n)
    bej = hl.backend_auto(nshards=S, dtype=np.float64)
    Aj = hl.DistSparseMatrix.from_scipy(A, bej)
    step_j, x0 = _cg_step_fn(Aj, bej)
    step_j = jax.jit(step_j)
    bj = hl.DistVector.from_global(bh, bej)
    x, r, p = x0.data, bj.data, bj.data
    for _ in range(3):  # carry a mid-iteration state across
        x, r, p = step_j(x, r, p)

    bet = ht.backend_auto(S, device="cpu")
    At = ht.from_reference(bet, **_matrix_state(Aj))
    assert At.hash == Aj.hash
    part = np.asarray(Aj.row_partition)
    xt, rt, pt = (ht.from_reference(bet, data=np.asarray(v), partition=part)
                  for v in (x, r, p))
    for _ in range(20):
        x, r, p = step_j(x, r, p)
        xt, rt, pt = cg_step(At, xt, rt, pt)
    for tv, jv in ((xt, x), (rt, r), (pt, p)):
        want = np.asarray(jv)
        np.testing.assert_allclose(tv.data.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * abs(want).max())
    assert float(rt.norm()) < 0.5 * np.linalg.norm(bh), "CG must progress"

    xs_t = ht.ldlt(At).solve(ht.from_reference(
        bet, data=np.asarray(bj.data), partition=part)).to_numpy()
    xs_j = hl.ldlt(Aj).solve(bj).to_numpy()
    np.testing.assert_allclose(xs_t, xs_j, rtol=1e-10,
                               atol=1e-10 * abs(xs_j).max())
    assert np.linalg.norm(A @ xs_t - bh) / np.linalg.norm(bh) <= 1e-12


def test_from_reference_rejects_incomplete_state():
    be = ht.backend_auto(1, device="cpu")
    with pytest.raises(ValueError):
        ht.from_reference(be, data=np.zeros((1, 8)))
    with pytest.raises(ValueError):
        ht.from_reference(be, nzval=np.zeros((1, 8)))
    A = sp.eye(5, format="csr")
    Aj = hl.DistSparseMatrix.from_scipy(A, hl.backend_auto(nshards=1))
    state = _matrix_state(Aj)
    state["ncols"] = 6
    with pytest.raises(ValueError):
        ht.from_reference(be, **state)


@pytest.mark.parametrize("S", [1, 4])
def test_ridge_path_matches_reference(S, monkeypatch):
    """At the cut size N is 512 x 512 and A has 8*10^4 entries, so the
    engine thresholds are cut with it, in this test only: densify off (N
    would be a dense block), MIN_NNZ 2^14 (A and N are under 2^20) and the
    shared-memory cap scaled by n / 16384 (At's gathered x, 20,008 slots,
    would otherwise fit). The engines are then those of the full size:
    resident for N @ p and A @ x, ELL for At @ b."""
    m, n = 20_000, 512
    A, bh = banded_design(m, n, seed=8)
    monkeypatch.setattr(tspmv, "DENSE_MAX_ELEMS", 0)
    monkeypatch.setattr(tspmv, "MIN_NNZ", 1 << 14)
    monkeypatch.setattr(tk3, "H100_SMEM_CAP", tk3.H100_SMEM_CAP * n // 16384)
    ht.clear_plan_cache("vector_plan")
    f64 = torch.float64

    bet = ht.backend_auto(S, device="cpu")
    At = ht.DistSparseMatrix.from_scipy(A, bet)
    b = ht.DistVector.from_global(bh, bet)
    T = At.T.materialize()
    N = (T @ At).add_identity(RIDGE_LAMBDA)
    rhs = T @ b
    xk, _ = _cg(N, rhs, 50)
    x = ht.ldlt(N).solve(rhs)
    y = At @ x
    assert tspmv.get_spmv_plan(N, rhs).engine(f64) == "resident"
    assert tspmv.get_spmv_plan(T, b).engine(f64) == "ell"
    assert tspmv.get_spmv_plan(At, x).engine(f64) == "resident"

    bej = hl.backend_auto(nshards=S, dtype=np.float64)
    Aj = hl.DistSparseMatrix.from_scipy(A, bej)
    Tj = Aj.transpose_materialized()
    Nj = (Tj @ Aj).add_identity(RIDGE_LAMBDA)
    rhs_j = Tj @ hl.DistVector.from_global(bh, bej)
    x_j = hl.ldlt(Nj).solve(rhs_j).to_numpy()
    assert T.hash == Tj.hash and N.hash == Nj.hash
    for a in ("indptr", "col_indices", "colval"):
        for u, v in zip(getattr(N.structure, a), getattr(Nj.structure, a)):
            np.testing.assert_array_equal(u, v)

    def close(got, want, rtol):
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * abs(want).max())

    Nref = (A.T @ A + RIDGE_LAMBDA * sp.eye(n)).tocsr()
    close(N.nzval.numpy(), np.asarray(Nj.nzval), 1e-12)
    close(N.to_scipy().toarray(), Nref.toarray(), 1e-12)
    close(rhs.to_numpy(), rhs_j.to_numpy(), 1e-12)
    close(rhs.to_numpy(), A.T @ bh, 1e-12)
    xh = x.to_numpy()
    close(xh, x_j, 1e-10)
    r = Nref @ xh - A.T @ bh
    assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(A.T @ bh)
    # N's condition number is near 3: 50 CG steps reach the direct solution
    assert np.linalg.norm(xk.to_numpy() - xh) <= RIDGE_CG_RTOL * np.linalg.norm(xh)
    close(y.to_numpy(), A @ xh, 1e-12)

    sizes = ht.cache_sizes()          # new values, same pattern: no new plan
    A2 = At.with_values(At.nzval * 1.5)
    N2 = A2.T.materialize() @ A2
    assert ht.cache_sizes() == sizes and N2.structure is N.structure
    close(N2.to_scipy().toarray(), 2.25 * (A.T @ A).toarray(), 1e-12)
    ht.clear_plan_cache("vector_plan")


@pytest.mark.parametrize("S", [1, 4])
def test_multi_response_ridge_matches_reference(S, monkeypatch):
    """The dense slice as a whole: the multi-response ridge of
    ``chip_smoke.py`` phase 8, cut to m = 20,000 and n = 512 with k = 8
    responses. R = At @ Y (SpMM on the ELL engine, densify off as in the
    ridge test above), Xh = solve(N, R) from the host multi-RHS sweep,
    N @ Xh, Xh.T @ Xh and A @ Xh - Y through both packages and scipy."""
    m, n, k = 20_000, 512, 8
    A, _ = banded_design(m, n, seed=8)
    Y = np.random.default_rng(9).standard_normal((m, k))
    monkeypatch.setattr(tspmv, "DENSE_MAX_ELEMS", 0)
    monkeypatch.setattr(jspmv, "DENSE_MAX_ELEMS", 0)
    ht.clear_plan_cache()
    hl.clear_plan_cache()

    bet = ht.backend_auto(S, device="cpu")
    Ad = ht.DistSparseMatrix.from_scipy(A, bet)
    T = Ad.T.materialize()
    N = (T @ Ad).add_identity(RIDGE_LAMBDA)
    Yd = ht.DistDenseMatrix.from_global(Y, bet)
    R = T @ Yd
    assert tspmv.get_spmm_plan(T, Yd).ell
    Xh = ht.solve(N, R)
    assert isinstance(Xh, ht.DistDenseMatrix)
    np.testing.assert_array_equal(Xh.row_partition, N.row_partition)
    res = (N @ Xh - R).norm() / R.norm()
    G = Xh.T @ Xh
    E = Ad @ Xh - Yd

    bej = hl.backend_auto(nshards=S, dtype=np.float64)
    Aj = hl.DistSparseMatrix.from_scipy(A, bej)
    Tj = Aj.transpose_materialized()
    Nj = (Tj @ Aj).add_identity(RIDGE_LAMBDA)
    Yj = hl.DistDenseMatrix.from_global(Y, bej)
    Rj = Tj @ Yj
    Xj = hl.solve(Nj, Rj)

    def close(got, want, rtol):
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * abs(want).max())

    assert R.hash == Rj.hash and Xh.hash == Xj.hash
    close(R.data.numpy(), np.asarray(Rj.data), 1e-12)
    close(R.to_numpy(), A.T @ Y, 1e-12)
    xh = Xh.to_numpy()
    close(xh, Xj.to_numpy(), 1e-10)
    assert float(res) <= 1e-10
    close(G.to_numpy(), xh.T @ xh, 1e-12)
    close(G.to_numpy(), (Xj.T @ Xj).to_numpy(), 1e-10)
    close(E.to_numpy(), A @ xh - Y, 1e-12)
    hl.clear_plan_cache()
    ht.clear_plan_cache()


def _cg(A, b, steps):
    x = ht.DistVector.zeros(b.n, b.backend)
    r, p = b, b
    for _ in range(steps):
        x, r, p = cg_step(A, x, r, p)
    return x, r


@pytest.mark.parametrize("S", [1, 4])
def test_kkt_assembly(S, tmp_path):
    """The saddle-point assembly of chip_smoke.py phase 10 at k = 12,
    m = 30: every step held against scipy by ``kkt.drive`` itself, and the
    assembled, sliced and edited K against the JAX package's (structure,
    hash and values bit for bit)."""
    from hpclinalg_torch.tools import kkt

    I = kkt.Inputs(12, 30, seed=5)
    be = ht.backend_auto(S, device="cpu")
    out = kkt.drive(be, I, trace_dir=str(tmp_path))
    assert out["engine"] in ("dia", "densify", "ell", "resident", "segment")
    bj = hl.backend_auto(nshards=S)
    Kj = hl.cat(*[hl.DistSparseMatrix.from_scipy(M, bj)
                  for M in (I.A, I.Bt, I.B, I.C)], dims=(2, 2))
    Kt = ht.cat(*[ht.DistSparseMatrix.from_scipy(M, be)
                  for M in (I.A, I.Bt, I.B, I.C)], dims=(2, 2))
    n = I.n
    for t, j in ((Kt, Kj), (Kt[0:n, 0:n], Kj[0:n, 0:n]),
                 (Kt[I.p, I.p], Kj[I.p, I.p]), (Kt[n:, :], Kj[n:, :])):
        assert t.hash == j.hash
        np.testing.assert_array_equal(t.host_values(),
                                      np.asarray(j.to_scipy().data))
    Kt[I.bnd, I.bnd] = sp.eye(len(I.bnd))
    Kj[I.bnd, I.bnd] = sp.eye(len(I.bnd))
    assert Kt.hash == Kj.hash
    np.testing.assert_array_equal(Kt.to_scipy().toarray(),
                                  I.K_edit.toarray())
    for name in ("norm", "tr", "maximum", "minimum", "mean"):
        np.testing.assert_allclose(float(getattr(Kt, name)()),
                                   float(getattr(Kj, name)()), rtol=1e-12)
    for p in (1, np.inf):
        np.testing.assert_allclose(float(Kt.opnorm(p)), float(Kj.opnorm(p)),
                                   rtol=1e-12)


@pytest.mark.parametrize("S", [1, 4])
def test_from_reference_after_cat_index_and_assignment(S):
    """A matrix the JAX package built with cat, __getitem__ and
    __setitem__ carries over with its hash; the same operation on both
    sides then gives bit-equal results."""
    from hpclinalg_torch.tools import kkt

    I = kkt.Inputs(10, 20, seed=6)
    bj = hl.backend_auto(nshards=S)
    bt = ht.backend_auto(S, device="cpu")
    Kj = hl.cat(*[hl.DistSparseMatrix.from_scipy(M, bj)
                  for M in (I.A, I.Bt, I.B, I.C)], dims=(2, 2))
    Kj[I.bnd, I.bnd] = sp.eye(len(I.bnd))
    Sj = Kj[I.p, I.p]
    vj = hl.DistVector.from_global(I.z, bj)[5:80]
    vj[np.array([3, 9, 3])] = np.array([1.0, 2.0, 3.0])
    for Mj in (Kj, Sj):
        Mt = ht.from_reference(bt, Mj)
        assert Mt.hash == Mj.hash
        np.testing.assert_array_equal(Mt.to_scipy().toarray(),
                                      Mj.to_scipy().toarray())
        np.testing.assert_array_equal(Mt[3:40, 7:].to_scipy().toarray(),
                                      Mj[3:40, 7:].to_scipy().toarray())
        assert Mt[3:40, 7:].hash == Mj[3:40, 7:].hash
        Mt[[0, 2], [1]] = np.array([[4.0], [5.0]])
        Mj[[0, 2], [1]] = np.array([[4.0], [5.0]])
        assert Mt.hash == Mj.hash
        np.testing.assert_array_equal(Mt.host_values(),
                                      np.asarray(Mj.to_scipy().data))
    vt = ht.from_reference(bt, vj)
    assert np.array_equal(vt.partition, vj.partition)
    np.testing.assert_array_equal(vt[2:50:3].to_numpy(),
                                  np.asarray(vj[2:50:3].to_numpy()))
    Vt = ht.vcat_vectors(vt, vt)
    Vj = hl.vcat_vectors(vj, vj)
    np.testing.assert_array_equal(Vt.to_numpy(), np.asarray(Vj.to_numpy()))
