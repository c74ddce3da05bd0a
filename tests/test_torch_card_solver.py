"""The device multifrontal solver on the card (``solver/device_mf.py``),
through the public API, with the host engine's fallback warning made an
error: the Cholesky of laplace2d(512) (n = 262,144) at S = 1 and 4
against the host engine, its factor and solve graphs against the eager
bodies; an indefinite LDLᵀ with a multi-RHS solve, an LU with its
transposed solve and a complex-symmetric c128 LDLᵀ at the smaller sizes;
the complex LDLᵀ of Helmholtz(256) in c128 and c64 and a complex LU; the
``solver="device"`` routing through ``ht.solve``; and a chain tree that
warns and takes the host engine. The right-hand sides come from fixed
seeds.

This file imports no JAX, so the card runs it with

    python -m pytest --noconftest -m card tests/test_torch_card_solver.py

Every test needs a CUDA device and skips without one.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg_torch as ht
from hpclinalg_torch.ops import cuda_ell
from hpclinalg_torch.parallel.mesh import allgather_full
from hpclinalg_torch.solver import device_mf
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.tools.matrices import (between_eigenvalues, helmholtz,
                                            laplace2d)

SEED = 0
DEV_K = 512            # laplace2d(512), n = 262,144
DEV_K_SMALL = 256      # the LDL, LU and multi-RHS cases
DEV_K_COMPLEX = 64     # the complex-symmetric case on S = 4
DEV_MULTI_K = 8        # right-hand sides of the multi-RHS case
CHAIN_N = 4000         # the tridiagonal chain tree that falls back to host
HELM_K = 256           # Helmholtz(256), n = 65,536: the complex device LDL
N_SPMV = 1_000_000     # the complex SpMV tests' vector length
# residual bounds of the complex device solves: c128 as the real ones,
# c64 as the JAX package's tests/test_cplx.py
CPLX_RES = {torch.complex128: 1e-10, torch.complex64: 1e-4}
CPLX = {"c128": (torch.complex128, np.complex128),
        "c64": (torch.complex64, np.complex64)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def no_host_fallback():
    """A silent host solve must fail the device cases."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error",
                                message="device multifrontal unavailable")
        yield
    ht.clear_plan_cache("backslash")
    ht.clear_plan_cache("device_mf")


def counted(fn):
    """fn() with the launch counters set to 0 just before and read just
    after: (result, {kernel: launches})."""
    torch.cuda.synchronize()
    dc.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dc.launch_counts()


def rel_res(M, x, b):
    return float(np.linalg.norm(M @ x - b) / np.linalg.norm(b))


def rel_gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def on_card(F, dev):
    return all(x.device == dev for fac in F.factors[0] + F.factors[1]
               for x in fac)


def graphed(F):
    """Factored by a graph replay, solved by replays of solve graphs."""
    assert F.refusal is None and F._factor_graph is not None
    assert F._solve_graphs


def cplx_vec(rng, n):
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


# ---- real values ------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("S", [1, 4])
def test_cholesky_against_the_host_engine(card, S):
    """ldlt(method="device", spd=True) of laplace2d(512): a
    DeviceFactorization on the plan's engine with its factors on the card;
    its solve within 1e-10 residual and 1e-9 of the host engine's, through
    K1 (refinement) and K2's gather (in and out plans); refactorize
    replays the factor graph; the graphed factor and solve within 1e-12 of
    the eager bodies; the solve graph holds the eager solve's gathers."""
    L = laplace2d(DEV_K)
    bh = np.random.default_rng(SEED + 20).standard_normal(L.shape[0])
    be = ht.backend_auto(S, dtype=np.float64, device=card)
    A = ht.DistSparseMatrix.from_scipy(L, be)
    b = ht.DistVector.from_global(bh, be)
    eng = device_mf.device_engine(A, "chol", np.float64)
    F = ht.ldlt(A, method="device", spd=True)
    assert isinstance(F, device_mf.DeviceFactorization)
    assert F.engine is eng and on_card(F, card)
    xhost = ht.ldlt(A).solve(bh)
    x, c = counted(lambda: F.solve(b).to_numpy())
    assert rel_res(L, x, bh) <= 1e-10
    assert np.linalg.norm(x - xhost) <= 1e-9 * np.linalg.norm(xhost)
    assert c["dia"] > 0 and c["gather"] > 0
    fg, sg = F._factor_graph, F._solve_graphs[(1, False)]
    F.refactorize(A)
    assert F._factor_graph is fg and F.refusal is None
    nnzb = np.concatenate([[0], np.cumsum(A.structure.nnz_local)])
    Avals = allgather_full(A.nzval, nnzb, be)
    eps = 1e-10 * float(A.nzval.abs().max())
    b3 = b.data[:, :, None]
    prepped = eng.invert(*eng.factor(Avals, eps)[:2])
    xe = eng.solve_prepped(prepped, b3)[:, :, 0]
    assert rel_gap(F._solve_dist(b.data, False), xe) <= 1e-12
    cuda_ell.gather.launches = 0
    eng.solve_prepped(prepped, b3)
    assert sg.held.get(cuda_ell.gather, 0) == cuda_ell.gather.launches > 0


@pytest.fixture(scope="module")
def small(card):
    """laplace2d(256), its right-hand side, and the indefinite shift."""
    k2 = DEV_K_SMALL
    n2 = k2 * k2
    sig = between_eigenvalues(k2, 0.5)
    return {"L": laplace2d(k2),
            "N": (laplace2d(k2) - sig * sp.eye(n2)).tocsr(),
            "b": np.random.default_rng(SEED + 21).standard_normal(n2)}


@pytest.mark.card
def test_indefinite_ldl_and_multi_rhs(card, small):
    """ldlt(method="device") of laplace2d(256) - sigma I: residual <= 1e-8
    through K1; solve_matrix of 8 right-hand sides through its own solve
    graph, residual through N @ X <= 1e-8; factored and solved through
    graphs."""
    N, b2h = small["N"], small["b"]
    be = ht.backend_auto(1, dtype=np.float64, device=card)
    Nd = ht.DistSparseMatrix.from_scipy(N, be)
    F = ht.ldlt(Nd, method="device")
    x, c = counted(lambda: F.solve(ht.DistVector.from_global(b2h, be))
                   .to_numpy())
    assert rel_res(N, x, b2h) <= 1e-8 and c["dia"] > 0
    Bh = np.random.default_rng(SEED + 22).standard_normal(
        (N.shape[0], DEV_MULTI_K))
    Bd = ht.DistDenseMatrix.from_global(Bh, be)
    X = F.solve_matrix(Bd)
    assert isinstance(X, ht.DistDenseMatrix)
    assert float((Nd @ X - Bd).norm()) <= 1e-8 * float(Bd.norm())
    assert (DEV_MULTI_K, False) in F._solve_graphs
    graphed(F)


@pytest.mark.card
def test_lu_with_its_transposed_solve(card, small):
    """lu(method="device") of laplace2d(256) with unsymmetric values on
    S = 4: both solves within 1e-9 residual, through graphs."""
    Lu = small["L"].copy()
    Lu.data = Lu.data * (1.0 + 0.2 * np.random.default_rng(SEED + 23)
                         .random(Lu.nnz))
    b2h = small["b"]
    be4 = ht.backend_auto(4, dtype=np.float64, device=card)
    F = ht.lu(ht.DistSparseMatrix.from_scipy(Lu, be4), method="device")
    bu = ht.DistVector.from_global(b2h, be4)
    x = F.solve(bu).to_numpy()
    xt = F.solve(bu, transpose=True).to_numpy()
    assert isinstance(F, device_mf.DeviceFactorization) and on_card(F, card)
    assert rel_res(Lu, x, b2h) <= 1e-9 and rel_res(Lu.T, xt, b2h) <= 1e-9
    assert (1, True) in F._solve_graphs
    graphed(F)


@pytest.mark.card
def test_complex_symmetric_ldl_four_shards(card):
    """c128 laplace2d(64) + 0.4i I on S = 4: the complex payloads cross the
    exchange, K1 runs its c128 instantiation; residual <= 1e-10."""
    kc = DEV_K_COMPLEX
    Ac = (laplace2d(kc).astype(np.complex128)
          + 0.4j * sp.eye(kc * kc)).tocsr()
    bec = ht.backend_auto(4, dtype=np.complex128, device=card)
    Acd = ht.DistSparseMatrix.from_scipy(Ac, bec)
    bch = cplx_vec(np.random.default_rng(SEED + 24), kc * kc)
    F = ht.ldlt(Acd, method="device")
    x, c = counted(lambda: F.solve(ht.DistVector.from_global(bch, bec))
                   .to_numpy())
    assert F.factors[0][0][0].dtype == torch.complex128 and on_card(F, card)
    assert rel_res(Ac, x, bch) <= 1e-10
    assert c["gather"] > 0 and c["dia"] > 0
    graphed(F)


@pytest.mark.card
def test_device_backend_routing(card, small):
    """A solver="device" backend: ht.solve takes the device engine; new
    values on the same pattern are a refactorize-only hit that replays its
    factor graph."""
    L, b2h = small["L"], small["b"]
    bed = ht.backend_auto(1, dtype=np.float64, device=card, solver="device")
    Ld = ht.DistSparseMatrix.from_scipy(L, bed)
    bd = ht.DistVector.from_global(b2h, bed)
    ht.clear_plan_cache("backslash")
    x1 = ht.solve(Ld, bd).to_numpy()
    cache = ht.BackslashCache._cache()
    F1 = next(iter(cache.values()))
    fg1 = F1._factor_graph
    Ld2 = Ld * 2.0
    x2 = ht.solve(Ld2, bd).to_numpy()
    assert isinstance(F1, device_mf.DeviceFactorization)
    assert len(cache) == 1 and next(iter(cache.values())) is F1
    assert F1.A is Ld2
    assert max(rel_res(L, x1, b2h), rel_res(2.0 * L, x2, b2h)) <= 1e-10
    assert fg1 is not None and F1._factor_graph is fg1


@pytest.mark.card
def test_chain_tree_takes_the_host_engine(card):
    """A tridiagonal chain through a solver="device" backend warns and
    takes the host engine."""
    bed = ht.backend_auto(1, dtype=np.float64, device=card, solver="device")
    T = sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1],
                 shape=(CHAIN_N, CHAIN_N)).tocsr()
    Td = ht.DistSparseMatrix.from_scipy(T, bed)
    bth = np.random.default_rng(SEED + 25).standard_normal(CHAIN_N)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        xc = ht.solve(Td, ht.DistVector.from_global(bth, bed)).to_numpy()
    Fc = [F for key, F in ht.BackslashCache._cache().items()
          if key[0] == Td.hash]
    assert any("host" in str(w.message) for w in caught)
    assert len(Fc) == 1 and isinstance(Fc[0], ht.Factorization)
    assert rel_res(T, xc, bth) <= 1e-10


# ---- complex values ---------------------------------------------------------

@pytest.fixture(scope="module")
def cplx(card):
    """Helmholtz(256), the complex LU's permuted matrix, and their
    right-hand sides: drawn after the complex SpMV tests' vectors (z and w
    of 10^6 complex entries, a real x of 10^6) from the same generator."""
    rng = np.random.default_rng(SEED + 40)
    rng.standard_normal(5 * N_SPMV)
    H = helmholtz(HELM_K)
    b5 = cplx_vec(rng, H.shape[0])
    r = np.random.default_rng(SEED + 47)
    Lu = laplace2d(DEV_K_SMALL)
    n2 = Lu.shape[0]
    Lu = sp.csr_matrix((Lu.data * (1.0 + 0.2 * r.random(Lu.nnz))
                        + 0.1j * r.standard_normal(Lu.nnz), Lu.indices,
                        Lu.indptr), shape=Lu.shape)
    perm = r.permutation(n2)
    P = Lu[perm][:, perm].tocsr()
    P.sort_indices()
    be = ht.backend_auto(1, dtype=np.complex128, device=card)
    xhost = ht.ldlt(ht.DistSparseMatrix.from_scipy(H, be)).solve(b5)
    return {"H": H, "b5": b5, "xhost": xhost, "P": P,
            "b2": cplx_vec(rng, n2)}


@pytest.mark.card
@pytest.mark.parametrize("S, dt", [(1, "c128"), (4, "c128"), (1, "c64")])
def test_complex_ldl_helmholtz(card, cplx, S, dt):
    """ldlt(method="device", spd=False) of Helmholtz(256): factors of the
    type, residual within CPLX_RES, c128 within 1e-9 of the host engine's
    solution, K1 in the refinement."""
    tdt, npdt = CPLX[dt]
    H, b5, xhost = cplx["H"], cplx["b5"], cplx["xhost"]
    be = ht.backend_auto(S, dtype=npdt, device=card)
    A = ht.DistSparseMatrix.from_scipy(H, be)
    b = ht.DistVector.from_global(b5, be)
    F = ht.ldlt(A, method="device", spd=False)
    x, c = counted(lambda: F.solve(b).to_numpy())
    Hr = H.astype(npdt).astype(np.complex128)
    br = b5.astype(npdt).astype(np.complex128)
    assert isinstance(F, device_mf.DeviceFactorization)
    assert F.factors[0][0][0].dtype == tdt
    assert rel_res(Hr, x, br) <= CPLX_RES[tdt]
    assert tdt == torch.complex64 or \
        np.linalg.norm(x - xhost) <= 1e-9 * np.linalg.norm(xhost)
    assert c["dia"] > 0


@pytest.mark.card
@pytest.mark.parametrize("S", [1, 4])
def test_complex_lu(card, cplx, S):
    """lu(method="device") of a permuted laplace2d(256) with unsymmetric
    complex values (its SpMV plan K2's) and its transposed solve: both
    within 1e-10 residual with refinement through K2."""
    from hpclinalg_torch.ops import spmv as spmv_mod

    P, b2 = cplx["P"], cplx["b2"]
    be = ht.backend_auto(S, dtype=np.complex128, device=card)
    Pd = ht.DistSparseMatrix.from_scipy(P, be)
    bd = ht.DistVector.from_global(b2, be)
    assert spmv_mod.get_spmv_plan(Pd, bd).engine(torch.complex128) == "ell"
    F = ht.lu(Pd, method="device")
    (x, xt), c = counted(lambda: (F.solve(bd).to_numpy(),
                                  F.solve(bd, transpose=True).to_numpy()))
    assert isinstance(F, device_mf.DeviceFactorization)
    assert rel_res(P, x, b2) <= 1e-10 and rel_res(P.T, xt, b2) <= 1e-10
    assert c["ell"] > 0


@pytest.mark.card
def test_complex_device_backend_routing(card, cplx):
    """A c128 solver="device" backend through ht.solve twice, the second
    time with new values on the same pattern: a refactorize-only hit."""
    P, b2 = cplx["P"], cplx["b2"]
    bed = ht.backend_auto(1, dtype=np.complex128, device=card,
                          solver="device")
    Pd = ht.DistSparseMatrix.from_scipy(P, bed)
    bd = ht.DistVector.from_global(b2, bed)
    ht.clear_plan_cache("backslash")
    x1 = ht.solve(Pd, bd).to_numpy()
    cache = ht.BackslashCache._cache()
    F1 = next(iter(cache.values()))
    s2 = 1.5 - 0.5j
    Pd2 = Pd * s2
    x2, c = counted(lambda: ht.solve(Pd2, bd).to_numpy())
    assert isinstance(F1, device_mf.DeviceFactorization)
    assert len(cache) == 1 and next(iter(cache.values())) is F1
    assert F1.A is Pd2
    assert max(rel_res(P, x1, b2), rel_res(s2 * P, x2, b2)) <= 1e-10
    assert c["ell"] > 0
