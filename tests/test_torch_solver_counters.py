"""The device solver's multi-RHS path in the port's span recorder
(``hpclinalg_torch/utils/profiling.py``), on the CPU, and a damped
complex-symmetric Helmholtz block solve against the JAX package's.

``solve_matrix`` runs inside one ``solver.solve_matrix`` span a call, as
``solve`` inside ``solver.solve``; ``solver.rhs_columns`` counts the
columns each call solves (1 for ``solve``, k for ``solve_matrix``), and
``solver.refine_sweeps`` each refinement sweep that solves again, in the
plain loop and in the extended one. The sweeps are counted against the
factor solves the call made (``_solve_dist`` calls less the first). A
solve made inexact by a relative 1e-3 on every factor solve makes the
refinement sweep several times.

The Helmholtz operator is PETSc ex11.c's 5-point -Δu - σ₁u + iσ₂u scaled
by h² (4 - s μ (1 - iη) on the diagonal, -1 to each neighbour), with a
seeded relative slowness μ in [0.8, 1.2]; its imaginary part is definite,
so the unpivoted LDLᵀ exists. The port's solution is held to the JAX
package's within rtol 1e-10 of its largest entry, as the other device
solver tests hold solutions.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from hpclinalg_torch.solver import device_mf
from hpclinalg_torch.tools.matrices import laplace2d
from hpclinalg_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.tracing(False)
    profiling.reset_trace()
    yield
    profiling.tracing(False)
    profiling.reset_trace()


def helmholtz_ex11(k, s=0.5, eta=0.1, seed=3):
    """ex11.c's damped operator on a k x k grid, h²-scaled, complex128."""
    mu = np.random.default_rng(seed).uniform(0.8, 1.2, k * k)
    return (laplace2d(k) - sp.diags(s * mu * (1 - 1j * eta))).tocsr()


def _rhs(n, k, dtype, seed=5):
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((n, k))
    if np.issubdtype(dtype, np.complexfloating):
        B = B + 1j * rng.standard_normal((n, k))
    return B.astype(dtype)


# name -> (matrix, kind, dtype, shards)
CASES = {
    "ldl_c128": (lambda: helmholtz_ex11(8), "ldl", np.complex128, 2),
    "chol_f64": (lambda: laplace2d(8), "chol", np.float64, 2),
    # an f32 engine refines a vector in f64 (``_extended_refine``)
    "chol_f32": (lambda: laplace2d(8), "chol", np.float32, 1),
}


def _factor(name):
    make, kind, dt, S = CASES[name]
    A = make().astype(dt)
    be = ht.backend_auto(S, dtype=dt, device="cpu")
    Ad = ht.DistSparseMatrix.from_scipy(A, be)
    F = ht.ldlt(Ad, method="device", spd=kind == "chol")
    assert isinstance(F, device_mf.DeviceFactorization)
    return A, be, F


def _count_factor_solves(monkeypatch, F, inexact: bool):
    """Counts ``F``'s factor solves; ``inexact`` scales each solution by
    1 + 1e-3, so that the refinement has something to correct."""
    calls = []
    real = F._solve_dist

    def solve_dist(b, transpose):
        calls.append(b.shape)
        x = real(b, transpose)
        return x * (1 + 1e-3) if inexact else x

    monkeypatch.setattr(F, "_solve_dist", solve_dist)
    return calls


@pytest.mark.parametrize("k", [1, 3])
def test_solve_matrix_opens_one_span_a_call(k):
    A, be, F = _factor("ldl_c128")
    n = A.shape[0]
    B = ht.DistDenseMatrix.from_global(_rhs(n, k, np.complex128), be)
    ht.tracing(True)
    for _ in range(2):
        F.solve_matrix(B)
    spans = ht.trace_report()["spans"]
    assert spans["solver.solve_matrix"]["calls"] == 2
    assert "solver.solve" not in spans
    # a host array in: the same span
    F.solve_matrix(_rhs(n, k, np.complex128))
    assert ht.trace_report()["spans"]["solver.solve_matrix"]["calls"] == 3


@pytest.mark.parametrize("name", list(CASES))
def test_rhs_columns_count_the_columns_solved(name):
    A, be, F = _factor(name)
    n, dt = A.shape[0], CASES[name][2]
    B = _rhs(n, 5, dt)
    ht.tracing(True)
    F.solve_matrix(ht.DistDenseMatrix.from_global(B, be))
    assert ht.trace_report()["counters"]["solver.rhs_columns"] == 5
    F.solve(ht.DistVector.from_global(B[:, 0], be))
    F.solve(B[:, 1])
    F.solve_matrix(B[:, :2])
    assert ht.trace_report()["counters"]["solver.rhs_columns"] == 5 + 2 + 2
    # off, nothing is counted
    ht.tracing(False)
    F.solve_matrix(B)
    assert ht.trace_report()["counters"]["solver.rhs_columns"] == 9


@pytest.mark.parametrize("inexact", [False, True])
@pytest.mark.parametrize("matrix_rhs", [False, True])
@pytest.mark.parametrize("name", list(CASES))
def test_refine_sweeps_equal_the_resolves(name, matrix_rhs, inexact,
                                          monkeypatch):
    A, be, F = _factor(name)
    n, dt = A.shape[0], CASES[name][2]
    B = _rhs(n, 4, dt)
    calls = _count_factor_solves(monkeypatch, F, inexact)
    ht.tracing(True)
    if matrix_rhs:
        X = F.solve_matrix(ht.DistDenseMatrix.from_global(B, be),
                           refine=6).to_numpy()
        b = B
    else:
        X = F.solve(ht.DistVector.from_global(B[:, 0], be),
                    refine=6).to_numpy()
        b = B[:, 0]
    counters = ht.trace_report()["counters"]
    sweeps = counters.get("solver.refine_sweeps", 0)
    assert sweeps == len(calls) - 1
    if inexact:
        # the scaled solves leave a residual that refinement works down
        assert sweeps >= 1
    tol = 1e-4 if dt == np.float32 else 1e-9
    res = np.linalg.norm(A @ X - b) / np.linalg.norm(b)
    assert res <= tol
    # the host reads: ‖b‖ and the ‖r‖ before each sweep
    assert counters["solver.host_reads"] >= sweeps + 1


def test_refine_sweeps_of_a_refactorize_and_solve_stream(monkeypatch):
    """Requests of refactorize + solve_matrix: the sweeps add up over the
    requests and the rhs columns are k a request."""
    A, be, F = _factor("ldl_c128")
    n = A.shape[0]
    B = ht.DistDenseMatrix.from_global(_rhs(n, 3, np.complex128), be)
    Ad = ht.DistSparseMatrix.from_scipy(A, be)
    calls = _count_factor_solves(monkeypatch, F, True)
    ht.tracing(True)
    for _ in range(3):
        F.refactorize(Ad)
        F.solve_matrix(B)
    rep = ht.trace_report()
    assert rep["counters"]["solver.rhs_columns"] == 9
    assert rep["counters"]["solver.refine_sweeps"] == len(calls) - 3
    assert rep["spans"]["solver.refactorize"]["calls"] == 3
    assert rep["spans"]["solver.solve_matrix"]["calls"] == 3


@pytest.fixture(scope="module")
def jax_helmholtz_block():
    """The JAX package's device LDLᵀ block solve of ex11.c's operator at
    grid 12 for 8 seeded complex columns, at S = 4."""
    A = helmholtz_ex11(12)
    B = _rhs(A.shape[0], 8, np.complex128, seed=9)
    be4 = hl.backend_auto(nshards=4, dtype=np.complex128)
    Fj = hl.ldlt(hl.DistSparseMatrix.from_scipy(A, be4), method="device")
    Xj = Fj.solve_matrix(hl.DistDenseMatrix.from_global(B, be4))
    return A, B, np.asarray(Xj.to_numpy())


@pytest.mark.parametrize("S", [1, 4])
def test_helmholtz_block_solve_matches_jax(S, jax_helmholtz_block):
    A, B, Xj = jax_helmholtz_block
    be = ht.backend_auto(S, dtype=np.complex128, device="cpu")
    F = ht.ldlt(ht.DistSparseMatrix.from_scipy(A, be), method="device")
    assert F.kind == "ldl" and F.n_perturbed == 0
    ht.tracing(True)
    X = F.solve_matrix(ht.DistDenseMatrix.from_global(B, be)).to_numpy()
    np.testing.assert_allclose(X, Xj, rtol=1e-10,
                               atol=1e-10 * np.abs(Xj).max())
    assert np.linalg.norm(A @ X - B) / np.linalg.norm(B) <= 1e-12
    assert ht.trace_report()["counters"]["solver.rhs_columns"] == 8
