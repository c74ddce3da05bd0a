"""The port's main path as a whole against the JAX package's.

The JAX side runs ``__graft_entry__._cg_step_fn`` (the library's own CG
step). Its matrix and its CG state x, r, p in the middle of an iteration
are handed to the port through ``from_reference`` as numpy arrays; both
then take 20 more steps in f64 and must agree to rtol 1e-9 (CG amplifies
last-bit differences in the reductions a little each step). The port's
step uses only the public API. Then ``ldlt(A).solve(b)`` of both agree to
1e-10."""

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from __graft_entry__ import _cg_step_fn, _laplace2d

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
