"""The device solver's factor and solves as CUDA graphs
(``solver/device_mf.DeviceFactorization`` over ``utils/graphs``), on the
CPU with the stand-in graph of ``test_torch_entry.standin_graphs``: the
record runs the body once and leaves its outputs NaN, and each replay
reruns the body and writes its results into those same tensors, as a CUDA
graph's replay does.

The graphed path is held against the JAX package's engine
(``hpclinalg.solver.device_mf``, x64) at the shard counts of
``tests/conftest.py`` for the Cholesky, an LDLᵀ with a perturbed pivot
and an LU, with the tolerances of ``tests/test_torch_device_solver.py``:
factors rtol 1e-12 (atol 1e-12 of the largest entry), growth rtol 1e-10,
solutions rtol 1e-10 of the JAX solution, residuals 1e-10. Against the
eager bodies on the same inputs the graphed path is the same arithmetic
in the same order on the CPU, and is held bit for bit. Then what a graph
changes: results the graph rewrites must not reach a caller's earlier
result, two factorizations of one pattern keep their own factors, a
``refactorize`` replays with no new capture, a new right-hand-side width
takes a new solve graph, a failed capture raises, and CPU tensors run the
eager bodies (gloo ranks: ``test_torch_dist_solvers.py``)."""

from functools import lru_cache

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from hpclinalg.solver import device_mf as jdm
from hpclinalg_torch.solver import device_mf as tdm
from hpclinalg_torch.tools.matrices import laplace2d
from hpclinalg_torch.utils import graphs
from test_torch_entry import standin_graphs

torch.set_num_threads(1)

SHARDS = (1, 4, 8)          # conftest.CONFIGS' shard counts


def zero_pivot():
    """laplace2d(6) beside the 2 x 2 swap [[0, 1], [1, 0]]: indefinite and
    well conditioned, and the unpivoted LDLᵀ meets one exact zero pivot,
    which it clamps to eps. The swap block is a tree of its own, so the
    1/eps growth stays in it (a zero pivot inside laplace2d's tree makes
    its ancestors' Schur complements cancel terms of 1/eps, whose rounding
    then depends on the summation order)."""
    return sp.block_diag([laplace2d(6), sp.csr_matrix([[0.0, 1.0],
                                                       [1.0, 0.0]])]).tocsr()


# name -> (matrix, kind)
CASES = {"chol": (lambda: laplace2d(8), "chol"),
         "ldl": (zero_pivot, "ldl"),
         "lu": (lambda: (laplace2d(7) + sp.random(
             49, 49, 0.05, random_state=np.random.default_rng(105))).tocsr(),
             "lu")}


def rhs(n, k=None, seed=11):
    shape = (n,) if k is None else (n, k)
    return np.random.default_rng(seed).standard_normal(shape)


def rel_res(A, x, b):
    return np.linalg.norm(A @ x - b) / np.linalg.norm(b)


@lru_cache(maxsize=None)
def jax_case(name, S):
    """(JAX factorization, its solution of rhs, its transposed solution
    for LU) at S shards."""
    M, kind = CASES[name][0](), CASES[name][1]
    be = hl.backend_auto(nshards=S)
    Fj = jdm.DeviceFactorization(hl.DistSparseMatrix.from_scipy(M, be),
                                 kind=kind)
    b = rhs(M.shape[0])
    x = Fj.solve(hl.DistVector.from_global(b, be)).to_numpy()
    xt = Fj.solve(hl.DistVector.from_global(b, be), transpose=True) \
        .to_numpy() if kind == "lu" else None
    return Fj, x, xt


def factorization(name, S, M=None):
    """The port's DeviceFactorization of case ``name`` (or of ``M`` on its
    pattern) at S shards on the CPU, and its matrix."""
    M = CASES[name][0]() if M is None else M
    be = ht.backend_auto(S, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(M, be)
    return tdm.DeviceFactorization(A, kind=CASES[name][1]), A


def held(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_graphed_factorization_equals_jax(monkeypatch, name, S):
    """The factor graph (tensor eps, counts and growth in the graph) and
    the solve graphs against the JAX engine, and bit for bit against the
    eager bodies."""
    eager, _ = factorization(name, S)
    made = standin_graphs(monkeypatch)
    F, A = factorization(name, S)
    assert F.refusal is None and made == [F._factor_graph.graph]
    assert eager.refusal is not None and eager._factor_graph is None
    Fj, xj, xjt = jax_case(name, S)
    for facs_t, facs_j, facs_e in zip(F.factors[:2], Fj.factors[:2],
                                      eager.factors[:2]):
        assert len(facs_t) == len(facs_j)
        for ft, fj, fe in zip(facs_t, facs_j, facs_e):
            assert len(ft) == len(fj)
            for a, b, e in zip(ft, fj, fe):
                assert torch.equal(a, e)
                if np.asarray(b).size:
                    held(a.numpy(), b, 1e-12)
    assert F.n_perturbed == Fj.n_perturbed == eager.n_perturbed
    assert (F.n_perturbed > 0) == (name == "ldl")
    assert F.growth == pytest.approx(Fj.growth, rel=1e-10)
    assert F.growth == eager.growth and F._unstable == Fj._unstable
    M, b = CASES[name][0](), rhs(A.m)
    bd = ht.DistVector.from_global(b, A.backend)
    x = F.solve(bd).to_numpy()
    held(x, xj, 1e-10)
    assert rel_res(M, x, b) <= 1e-10
    np.testing.assert_array_equal(x, eager.solve(bd).to_numpy())
    keys = [(1, False)]
    if name == "lu":
        xt = F.solve(bd, transpose=True).to_numpy()
        held(xt, xjt, 1e-10)
        assert rel_res(M.T, xt, b) <= 1e-10
        np.testing.assert_array_equal(
            xt, eager.solve(bd, transpose=True).to_numpy())
        keys.append((1, True))
    assert sorted(F._solve_graphs) == keys
    assert made == [F._factor_graph.graph] + [F._solve_graphs[k].graph
                                              for k in keys]


@pytest.mark.parametrize("name", ("ldl", "lu"))
def test_a_solve_is_not_changed_by_later_solves(monkeypatch, name):
    """The solve graph rewrites its output at every replay: a result
    handed out before, and the refinement's running sum, stay as they
    were (``_refined_solve``'s ``Xs + solve(R)`` reads Xs after the
    correction's replay)."""
    standin_graphs(monkeypatch)
    F, A = factorization(name, 4)
    eager, _ = factorization(name, 4)
    M = CASES[name][0]()
    b1, b2 = rhs(A.m, seed=1), rhs(A.m, seed=2)
    d1 = ht.DistVector.from_global(b1, A.backend)
    d2 = ht.DistVector.from_global(b2, A.backend)
    x1 = F.solve(d1, refine=0)
    keep = x1.to_numpy().copy()
    x2 = F.solve(d2, refine=3)
    x3 = F.solve(d2, refine=0)
    np.testing.assert_array_equal(x1.to_numpy(), keep)
    np.testing.assert_array_equal(keep, eager.solve(d1, refine=0).to_numpy())
    np.testing.assert_array_equal(x2.to_numpy(),
                                  eager.solve(d2, refine=3).to_numpy())
    assert rel_res(M, x2.to_numpy(), b2) <= 1e-10
    assert x3.data.data_ptr() != x1.data.data_ptr()
    assert F._solve_graphs[(1, False)].graph.replays >= 3


def test_two_factorizations_of_one_pattern_keep_their_own_factors(
        monkeypatch):
    """The engine is shared by every factorization of a pattern; the
    graphs, and so the factors they write, are each factorization's."""
    standin_graphs(monkeypatch)
    M = CASES["chol"][0]()
    M2 = (2.0 * M + sp.eye(M.shape[0])).tocsr()
    F1, A1 = factorization("chol", 4)
    F2, A2 = factorization("chol", 4, M2)
    assert F1.engine is F2.engine
    assert F1._factor_graph is not F2._factor_graph
    b = rhs(A1.m)
    bd = ht.DistVector.from_global(b, A1.backend)
    for _ in range(2):
        x1, x2 = F1.solve(bd).to_numpy(), F2.solve(bd).to_numpy()
        assert rel_res(M, x1, b) <= 1e-10 and rel_res(M2, x2, b) <= 1e-10
    F1.refactorize(A1 * 3.0)
    assert rel_res(M2, F2.solve(bd).to_numpy(), b) <= 1e-10
    assert rel_res(3.0 * M, F1.solve(bd).to_numpy(), b) <= 1e-10


@pytest.mark.parametrize("name", sorted(CASES))
def test_refactorize_replays_and_equals_a_fresh_factorization(monkeypatch,
                                                              name):
    made = standin_graphs(monkeypatch)
    F, A = factorization(name, 4)
    b = rhs(A.m)
    bd = ht.DistVector.from_global(b, A.backend)
    F.solve(bd)
    graph, recorded = F._factor_graph, len(made)
    replays = graph.graph.replays
    A2 = A * 3.0
    assert F.refactorize(A2) is F
    assert F._factor_graph is graph and len(made) == recorded
    assert graph.graph.replays == replays + 1
    fresh = tdm.DeviceFactorization(A2, kind=F.kind)
    for ft, ff in zip(F.factors[0] + F.factors[1],
                      fresh.factors[0] + fresh.factors[1]):
        for a, c in zip(ft, ff):
            assert torch.equal(a, c)
    assert (F.n_perturbed, F.growth) == (fresh.n_perturbed, fresh.growth)
    np.testing.assert_array_equal(F.solve(bd).to_numpy(),
                                  fresh.solve(bd).to_numpy())
    assert len(made) == recorded + 2        # fresh's factor and solve only
    F.finalize()
    assert F._factor_graph is None and F._solve_graphs == {}
    with pytest.raises(RuntimeError, match="finalized"):
        F.solve(bd)


def test_a_new_rhs_width_takes_a_new_solve_graph(monkeypatch):
    """One solve graph a (width, transpose), as ``jax.jit`` traces one a
    shape: no bucketing of widths."""
    made = standin_graphs(monkeypatch)
    F, A = factorization("lu", 4)
    M = CASES["lu"][0]()
    for k in (3, 1, 3, 5, 1):
        B = rhs(A.m, k=k, seed=k)
        X = F.solve_matrix(ht.DistDenseMatrix.from_global(B, A.backend))
        assert np.linalg.norm(M @ X.to_numpy() - B) / np.linalg.norm(B) \
            <= 1e-10
    XT = F.solve_matrix(rhs(A.m, k=3), transpose=True)
    assert np.linalg.norm(M.T @ XT - rhs(A.m, k=3)) \
        / np.linalg.norm(rhs(A.m, k=3)) <= 1e-10
    assert sorted(F._solve_graphs) == [(1, False), (3, False), (3, True),
                                       (5, False)]
    assert len(made) == 5


def test_a_failed_capture_raises(monkeypatch):
    """A capture that fails raises: nothing runs the eager bodies in the
    graph's place."""
    standin_graphs(monkeypatch)

    def fails(fn, device):
        raise RuntimeError("capture: the step could not be captured as a "
                           "CUDA graph: operation not permitted")

    monkeypatch.setattr(graphs, "record", fails)
    with pytest.raises(RuntimeError, match="could not be captured"):
        factorization("chol", 4)


def test_cpu_tensors_run_the_eager_bodies(monkeypatch):
    """On CPU tensors (no stand-in) the factorization says why it runs
    eagerly and records no graph."""
    def never(fn, device):
        raise AssertionError("a CPU factorization recorded a graph")

    monkeypatch.setattr(graphs, "record", never)
    F, A = factorization("ldl", 4)
    assert "CUDA tensors" in F.refusal and F._factor_graph is None
    b = rhs(A.m)
    assert rel_res(CASES["ldl"][0](), F.solve(b), b) <= 1e-10
    assert F._solve_graphs == {}
