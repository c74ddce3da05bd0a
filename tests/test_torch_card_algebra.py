"""The sparse and dense algebra on the card at the main path's sizes,
through the public API, f64 unless said: the ridge-regression path (a
10^6 x 16384 banded design A: At = A.T.materialize(), the pair SpGEMM
N = At @ A + 10⁻²I, At @ b, CG on N, the host ldlt of N, the refit that
reuses every plan) at S = 1 and 4; the DIA SpGEMM laplace2d(100)²; the
SpMM (the random 10^6 x 8 matrix times 64 columns, laplace2d(1000) times
8), the multi-response ridge (R = At @ Y, solve(N, R), X.T @ X) and the
dense operations; and the saddle-point assembly of ``tools/kkt.py`` at
k = 1000, m = 10⁴, each step held against scipy. The matrices are made
from fixed seeds.

This file imports no JAX, so the card runs it with

    python -m pytest --noconftest -m card tests/test_torch_card_algebra.py

Every test needs a CUDA device and skips without one.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg_torch as ht
from hpclinalg_torch.ops import spgemm as spgemm_mod
from hpclinalg_torch.ops import spmv as spmv_mod
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.tools import kkt
from hpclinalg_torch.tools.matrices import (RIDGE_CG_RTOL, RIDGE_LAMBDA,
                                            banded_design, laplace2d,
                                            random_8, random_cols)

SEED = 0
N = 1_000_000
K = 1000
RIDGE_M, RIDGE_N = 1_000_000, 16_384
RIDGE_CG_STEPS = 50
RIDGE_RES_TOL = 1e-10
SPMM_K = 64             # columns of the random SpMM and responses of the ridge
SPMM_RTOL = {np.float32: 1e-5, np.float64: 1e-12}
DENSE_M, DENSE_N = 10_000, 512
KKT_M, KKT_SEED = 10_000, 30


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def ridge(card):
    """The design A, its right-hand side b and scipy's N = AᵀA + λI."""
    Ab, bh = banded_design(RIDGE_M, RIDGE_N, SEED + 8)
    N_sc = (Ab.T @ Ab + RIDGE_LAMBDA * sp.eye(RIDGE_N)).tocsr()
    N_sc.sort_indices()
    return Ab, bh, N_sc


@pytest.fixture(scope="module")
def dense(card, ridge):
    """The dense operands, drawn from one generator in a fixed order."""
    rng = np.random.default_rng(SEED + 9)
    out = {"X": rng.standard_normal((N, SPMM_K)),
           "X8": rng.standard_normal((N, 8)),
           "Y": rng.standard_normal((RIDGE_M, SPMM_K)),
           "D": rng.standard_normal((DENSE_M, DENSE_N)),
           "E": rng.standard_normal((DENSE_N, SPMM_K)),
           "v": rng.standard_normal(DENSE_N),
           "w": rng.standard_normal(DENSE_M),
           "R8": random_8(N, SEED + 1), "L1000": laplace2d(K),
           "Bsp": random_cols(DENSE_N, 2048, 16, SEED + 10)}
    out["AtY"] = ridge[0].T @ out["Y"]
    return out


def close(got, want, rtol):
    """max |got - want| <= rtol max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= rtol * max(scale, 1e-300), (err, rtol, scale)


# ---- the ridge path ---------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("S", [1, 4])
def test_ridge_path(card, ridge, S):
    """N @ p takes K3, At @ b K2 and A @ x K3; the path launches K3 once a
    CG step at least; N has scipy's pattern and values; the CG iterate
    equals ldlt(N)'s solution to RIDGE_CG_RTOL; the refit reuses every
    plan."""
    A, bh, N_sc = ridge
    f64 = torch.float64
    be = ht.backend_auto(S, dtype=np.float64, device=card)
    Ad = ht.DistSparseMatrix.from_scipy(A, be)
    b = ht.DistVector.from_global(bh, be)
    torch.cuda.synchronize()
    dc.reset_launch_counts()
    At = Ad.T.materialize()
    C = At @ Ad
    N = C.add_identity(RIDGE_LAMBDA)
    rhs = At @ b
    xk, _ = dc.api_cg(N, rhs, RIDGE_CG_STEPS)
    F = ht.ldlt(N)
    x = F.solve(rhs)
    y = Ad @ x
    torch.cuda.synchronize()
    n = dc.launch_counts()
    assert n["resident"] >= RIDGE_CG_STEPS + 1 and n["ell"] >= 1
    assert (spmv_mod.get_spmv_plan(N, rhs).engine(f64),
            spmv_mod.get_spmv_plan(At, b).engine(f64),
            spmv_mod.get_spmv_plan(Ad, x).engine(f64)) == \
        ("resident", "ell", "resident")
    Nh = N.to_scipy()
    assert spmv_mod.get_spmv_plan(N, rhs).offsets is None
    assert np.array_equal(Nh.indptr, N_sc.indptr)
    assert np.array_equal(Nh.indices, N_sc.indices)
    close(Nh.data, N_sc.data, 1e-12)
    xh, rh = x.to_numpy(), rhs.to_numpy()
    close(rh, A.T @ bh, 1e-12)
    assert np.linalg.norm(N_sc @ xh - rh) <= 1e-10 * np.linalg.norm(rh)
    assert np.linalg.norm(xk.to_numpy() - xh) \
        <= RIDGE_CG_RTOL * np.linalg.norm(xh)
    close(y.to_numpy(), A @ xh, 1e-12)
    sizes = ht.cache_sizes()
    A2 = Ad.with_values(Ad.nzval * 1.5)
    C2 = A2.T.materialize() @ A2
    assert ht.cache_sizes() == sizes and C2.structure is C.structure
    close(C2.nzval.cpu(), 2.25 * C.nzval.cpu(), 1e-12)


@pytest.mark.card
@pytest.mark.parametrize("npdt, rtol", [(np.float64, 1e-12),
                                        (np.float32, 1e-6)],
                         ids=["f64", "f32"])
def test_spgemm_laplace(card, npdt, rtol):
    """laplace2d(100)² through the DIA SpGEMM engine: scipy's pattern and
    values."""
    L = laplace2d(100)
    ref = (L @ L).tocsr()
    ref.sort_indices()
    be = ht.backend_auto(1, dtype=npdt, device=card)
    Ld = ht.DistSparseMatrix.from_scipy(L, be)
    Ch = (Ld @ Ld).to_scipy()
    assert spgemm_mod.get_spgemm_plan(Ld, Ld).dia.ok
    assert np.array_equal(Ch.indptr, ref.indptr)
    assert np.array_equal(Ch.indices, ref.indices)
    close(Ch.data, ref.data, rtol)


# ---- the dense path ---------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("npdt", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("S", [1, 4])
def test_spmm_random(card, dense, S, npdt):
    """The random 10^6 x 8 matrix times a 10^6 x 64 DistDenseMatrix on the
    ELL engine against scipy."""
    be = ht.backend_auto(S, dtype=npdt, device=card)
    Ar = ht.DistSparseMatrix.from_scipy(dense["R8"], be)
    Xd = ht.DistDenseMatrix.from_global(dense["X"], be)
    C = Ar @ Xd
    assert spmv_mod.get_spmm_plan(Ar, Xd).ell
    assert isinstance(C, ht.DistDenseMatrix)
    close(C.to_numpy(), dense["R8"] @ dense["X"], SPMM_RTOL[npdt])


@pytest.mark.card
@pytest.mark.parametrize("S", [1, 4])
def test_spmm_laplace(card, dense, S):
    """laplace2d(1000) times a 10^6 x 8 block on the DIA engine."""
    be = ht.backend_auto(S, dtype=np.float64, device=card)
    Ld = ht.DistSparseMatrix.from_scipy(dense["L1000"], be)
    Cl = Ld @ ht.DistDenseMatrix.from_global(dense["X8"], be)
    assert spmv_mod.get_spmm_plan(Ld, Cl).offsets is not None
    close(Cl.to_numpy(), dense["L1000"] @ dense["X8"], 1e-12)


@pytest.mark.card
@pytest.mark.parametrize("S", [1, 4])
def test_multi_response_ridge(card, ridge, dense, S):
    """R = At @ Y on the ELL engine, Xh = solve(N, R) a DistDenseMatrix on
    N's rows with |N Xh - R| / |R| <= 1e-10, Xh.T @ Xh and A @ Xh - Y
    against numpy."""
    Ab, Y = ridge[0], dense["Y"]
    be = ht.backend_auto(S, dtype=np.float64, device=card)
    Ad = ht.DistSparseMatrix.from_scipy(Ab, be)
    At = Ad.T.materialize()
    Nm = (At @ Ad).add_identity(RIDGE_LAMBDA)
    Yd = ht.DistDenseMatrix.from_global(Y, be)
    R = At @ Yd
    assert spmv_mod.get_spmm_plan(At, Yd).ell
    close(R.to_numpy(), dense["AtY"], 1e-12)
    ht.clear_plan_cache("backslash")
    Xh = ht.solve(Nm, R)
    ht.clear_plan_cache("backslash")
    assert isinstance(Xh, ht.DistDenseMatrix)
    assert np.array_equal(Xh.row_partition, Nm.row_partition)
    assert float((Nm @ Xh - R).norm() / R.norm()) <= RIDGE_RES_TOL
    Xn = Xh.to_numpy()
    G = Xh.T @ Xh
    assert G.shape == (SPMM_K, SPMM_K)
    close(G.to_numpy(), Xn.T @ Xn, 1e-12)
    close((Ad @ Xh - Yd).to_numpy(), Ab @ Xn - Y, 1e-12)


@pytest.mark.card
@pytest.mark.parametrize("op", ["D @ v", "D.T @ w", "D @ E", "D @ B_sp"])
@pytest.mark.parametrize("S", [1, 4])
def test_dense_ops(card, dense, S, op):
    """A 10^4 x 512 DistDenseMatrix times a vector, its transpose times a
    vector, a dense and a sparse matrix, against numpy."""
    be = ht.backend_auto(S, dtype=np.float64, device=card)
    D, Bsp = dense["D"], dense["Bsp"]
    Dd = ht.DistDenseMatrix.from_global(D, be)
    got, want = {
        "D @ v": lambda: (Dd @ ht.DistVector.from_global(dense["v"], be),
                          D @ dense["v"]),
        "D.T @ w": lambda: (Dd.T @ ht.DistVector.from_global(dense["w"], be),
                            D.T @ dense["w"]),
        "D @ E": lambda: (Dd @ ht.DistDenseMatrix.from_global(dense["E"], be),
                          D @ dense["E"]),
        "D @ B_sp": lambda: (Dd @ ht.DistSparseMatrix.from_scipy(Bsp, be),
                             D @ Bsp.toarray())}[op]()
    close(got.to_numpy(), want, 1e-12)


# ---- the saddle-point assembly ----------------------------------------------

@pytest.mark.card
def test_kkt_assembly(card, tmp_path):
    """``kkt.drive`` at k = 1000, m = 10⁴ on S = 1 and 4, every step held
    against scipy (a failing check raises), one K @ z traced; over both
    drives K2 and its gather mode launched, and K1 where a plan gave a
    Laplacian block the DIA engine."""
    I = kkt.Inputs(K, KKT_M, seed=KKT_SEED)
    dc.reset_launch_counts()
    dia = False
    for S in (1, 4):
        be = ht.backend_auto(S, dtype=np.float64, device=card)
        out = kkt.drive(be, I, trace_dir=str(tmp_path / f"kkt_S{S}"))
        dia = dia or "dia" in (out["k11_engine"], out["blockdiag_engine"])
    n = dc.launch_counts()
    assert n["ell"] > 0 and n["gather"] > 0 and (n["dia"] > 0 or not dia)
