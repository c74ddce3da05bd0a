"""The device multifrontal solver and the dense containers on a
torch.distributed process group: one process a shard.

Each world (2 and 4 ranks, gloo, CPU) is spawned once for the module
(``parallel/launch.run_ranks``, a file-store rendezvous and a deadline),
and every rank runs ``tools/dist_checks.solver_checks`` on
``ht.backend_dist``: ``ldlt``/``lu(method="device")`` (Cholesky on a
partition with an empty shard, its refactorization with new values, the
indefinite LDLᵀ, the LU and its transposed solve, a c128 LDLᵀ, the
multi-RHS solve, a host-array right-hand side and the ``solver="device"``
backslash), and the dense containers (arithmetic, the products, the
transpose, the reductions, a repartition, sparse × dense on every SpMM
engine, dense × sparse, the host multi-RHS solves). Each result is held
against the port's stacked backend at the same S (a rank's rows against
that row of the stack) and against the JAX package over a mesh of the same
S on the same seeded inputs: solutions within 1e-10 relative, moved values
bit for bit, sums within 1e-12 of the largest entry. ``n_perturbed``,
``growth`` and a digest of the plan must be the same on every rank."""

from contextlib import ExitStack

import numpy as np
import pytest
import torch

import hpclinalg as hl
import hpclinalg.ops.mixed as jmixed
import hpclinalg.ops.spmv as jspmv
import hpclinalg_torch as ht
from hpclinalg_torch.parallel.launch import run_ranks
from hpclinalg_torch.tools import dist_checks as dc

torch.set_num_threads(1)

DEADLINE_S = 120
SOLVE_RTOL = 1e-10
RTOL = 1e-12

SOLUTIONS = ("chol", "refactor", "ldl", "lu", "lu_t", "c128", "backslash")
KINDS = ("chol", "ldl", "lu", "c128")
# dense results whose values are copied, never summed
MOVED = ("D", "transpose", "repartition")
DENSE_MATRICES = ("D", "arith", "neg_abs", "matmat", "transpose",
                  "lazy_matmat", "repartition", "spmm_dia", "spmm_densify",
                  "spmm_ell", "spmm_segment", "dxs_densify",
                  "dxs_transposes", "host_solve_matrix", "backslash_dense")
DENSE_SOLUTIONS = ("host_solve_matrix", "backslash_dense")
DENSE_VECTORS = ("matvec", "rmatvec", "lazy_rmatvec", "sum1")
REDUCTIONS = ("sum", "sum0", "norm2", "norm1", "norminf", "opnorm1",
              "opnorminf")


def patched_jax(stack, engine):
    """The JAX package's module limits of ``dc.SPMM_CASES[engine]``, and
    its ELL layout switched off for the segment engine, entered on
    ``stack``."""
    stack.enter_context(dc.patched(jspmv, **dc.SPMM_CASES[engine][1]))
    if engine == "segment":
        def no_ell(self, A):
            self.ell = False
        stack.enter_context(dc.patched(jspmv.SpMVPlan, _build_ell=no_ell))


def jax_solver_results(inp, S):
    """name -> a function giving the JAX package's device solution on
    ``dc.solver_inputs`` at S shards; "factor" -> a function giving its
    factorization of a kind, for the counts."""
    be = hl.backend_auto(nshards=S)
    bc = hl.backend_auto(nshards=S, dtype=np.complex128)
    bd = hl.backend_auto(nshards=S, solver="device")
    p = inp["p"]
    A = hl.DistSparseMatrix.from_scipy(inp["L"], be, row_partition=p)
    b = hl.DistVector.from_global(inp["b"], be, partition=p)
    bu = hl.DistVector.from_global(inp["b"], be)
    fac = {}

    def factor(kind):
        if kind not in fac:
            if kind == "chol":
                fac[kind] = hl.ldlt(A, method="device", spd=True)
            elif kind == "ldl":
                fac[kind] = hl.ldlt(hl.DistSparseMatrix.from_scipy(
                    inp["N"], be), method="device")
            elif kind == "lu":
                fac[kind] = hl.lu(hl.DistSparseMatrix.from_scipy(
                    inp["Lu"], be), method="device")
            else:
                fac[kind] = hl.ldlt(hl.DistSparseMatrix.from_scipy(
                    inp["H"], bc), method="device")
        return fac[kind]

    def refactor():
        F = hl.ldlt(A, method="device", spd=True)
        A2 = hl.DistSparseMatrix.from_scipy(inp["L2"], be, row_partition=p)
        return F.refactorize(A2).solve(b)

    def backslash():
        hl.clear_plan_cache("backslash")
        return hl.solve(hl.DistSparseMatrix.from_scipy(inp["L"], bd),
                        hl.DistVector.from_global(inp["b"], bd))

    return {
        "factor": factor,
        "chol": lambda: factor("chol").solve(b),
        "chol_host": lambda: factor("chol").solve(inp["b"]),
        "chol_matrix": lambda: factor("chol").solve_matrix(
            hl.DistDenseMatrix.from_global(inp["B"], be, row_partition=p)),
        "refactor": refactor,
        "ldl": lambda: factor("ldl").solve(bu),
        "lu": lambda: factor("lu").solve(bu),
        "lu_t": lambda: factor("lu").solve(bu, transpose=True),
        "c128": lambda: factor("c128").solve(
            hl.DistVector.from_global(inp["bc"], bc)),
        "backslash": backslash,
    }


def jax_dense_results(inp, S):
    """name -> a function giving the JAX package's result on
    ``dc.dense_inputs`` at S shards."""
    be = hl.backend_auto(nshards=S)
    p = inp["p"]
    D = hl.DistDenseMatrix.from_global(inp["D"], be, row_partition=p)
    D2 = hl.DistDenseMatrix.from_global(inp["D2"], be, row_partition=p)
    w = hl.DistVector.from_global(inp["w"], be, partition=p)

    def spmm(engine):
        mat = dc.SPMM_CASES[engine][0]
        M = hl.DistSparseMatrix.from_scipy(inp[mat], be)
        B = hl.DistDenseMatrix.from_global(inp[f"B_{mat}"], be,
                                           row_partition=inp[f"pb_{mat}"])
        hl.clear_plan_cache("vector_plan")
        with ExitStack() as stack:
            patched_jax(stack, engine)
            C = M @ B
        hl.clear_plan_cache("vector_plan")
        return C

    def dxs_transposes():
        with dc.patched(jmixed, DXS_DENSIFY_MAX_ELEMS=0):
            return D @ hl.DistSparseMatrix.from_scipy(inp["Sp"], be)

    def host_solves(how):
        Ls = hl.DistSparseMatrix.from_scipy(inp["Ls"], be)
        Y = hl.DistDenseMatrix.from_global(inp["Y"], be)
        hl.clear_plan_cache("backslash")
        X = hl.ldlt(Ls).solve_matrix(Y) if how == "ldlt" else hl.solve(Ls, Y)
        hl.clear_plan_cache("backslash")
        return X

    return {
        "D": lambda: D, "arith": lambda: 2.0 * D + D2 - 1.5,
        "neg_abs": lambda: abs(-D),
        "matmat": lambda: D @ hl.DistDenseMatrix.from_global(inp["E"], be),
        "transpose": lambda: D.transpose_materialized(),
        "lazy_matmat": lambda: D.T @ D,
        "repartition": lambda: D.repartition(inp["pu"]),
        **{f"spmm_{e}": (lambda e=e: spmm(e)) for e in dc.SPMM_CASES},
        "dxs_densify": lambda: D @ hl.DistSparseMatrix.from_scipy(
            inp["Sp"], be),
        "dxs_transposes": dxs_transposes,
        "host_solve_matrix": lambda: host_solves("ldlt"),
        "backslash_dense": lambda: host_solves("solve"),
        "matvec": lambda: D @ hl.DistVector.from_global(inp["v"], be),
        "rmatvec": lambda: D.rmatvec(w), "lazy_rmatvec": lambda: D.T @ w,
        "sum1": lambda: D.sum(axis=1), "sum": lambda: D.sum(),
        "sum0": lambda: D.sum(axis=0), "norm2": lambda: D.norm(),
        "norm1": lambda: D.norm(1), "norminf": lambda: D.norm(np.inf),
        "opnorm1": lambda: D.opnorm(1), "opnorminf": lambda: D.opnorm(np.inf),
    }


class World:
    def __init__(self, S):
        self.S = S
        self.ranks = run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", S,
                               backend="gloo", device="cpu",
                               deadline_s=DEADLINE_S,
                               args=("solver_checks", {}))
        self.stacked = dc.solver_checks(ht.backend_auto(S, device="cpu"))
        self.sinp = dc.solver_inputs(S)
        self.dinp = dc.dense_inputs(S)
        self._fns = None
        self._jax = {}

    @property
    def fns(self):
        if self._fns is None:
            self._fns = {**jax_solver_results(self.sinp, self.S),
                         **jax_dense_results(self.dinp, self.S)}
        return self._fns

    def rows(self, key):
        """Every rank's rows of ``key``, stacked: the distributed result in
        the stacked layout."""
        return np.concatenate([r[key] for r in self.ranks])

    def same_on_every_rank(self, key):
        vals = [r[key] for r in self.ranks]
        for v in vals[1:]:
            np.testing.assert_array_equal(v, vals[0])
        return vals[0]

    def jax(self, name):
        if name not in self._jax:
            self._jax[name] = self.fns[name]()
        return self._jax[name]

    def jax_factor(self, kind):
        return self.fns["factor"](kind)


@pytest.fixture(scope="module", params=(2, 4), ids=("world2", "world4"))
def world(request):
    return World(request.param)


def held(got, want, rtol):
    """``got`` equals ``want`` bit for bit (rtol None) or within ``rtol``
    of the largest |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if rtol is None:
        np.testing.assert_array_equal(got, want)
        return
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= rtol * max(np.max(np.abs(want)) if want.size else 0.0,
                             1e-300), (err, rtol)


def test_ranks_hold_one_shard_and_import_no_jax(world):
    for r, out in enumerate(world.ranks):
        assert int(out["meta.rank"]) == r and int(out["meta.nlocal"]) == 1
        assert not bool(out["meta.jax"]) and not bool(out["meta.hpclinalg"])


# -- the device solver -----------------------------------------------------

@pytest.mark.parametrize("name", SOLUTIONS)
def test_device_solution_against_jax_and_stacked(world, name):
    xj = world.jax(name)
    held(world.rows(f"dsol.{name}.local"), np.asarray(xj.data), SOLVE_RTOL)
    held(world.same_on_every_rank(f"dsol.{name}.full"), xj.to_numpy(),
         SOLVE_RTOL)
    held(world.rows(f"dsol.{name}.local"),
         world.stacked[f"dsol.{name}.local"], SOLVE_RTOL)


def test_device_solve_matrix_and_host_rhs_against_jax(world):
    Xj = world.jax("chol_matrix")
    held(world.rows("dsol.chol_matrix.local"), np.asarray(Xj.data),
         SOLVE_RTOL)
    held(world.same_on_every_rank("dsol.chol_matrix.full"), Xj.to_numpy(),
         SOLVE_RTOL)
    held(world.rows("dsol.chol_matrix.local"),
         world.stacked["dsol.chol_matrix.local"], SOLVE_RTOL)
    held(world.same_on_every_rank("dsol.chol_host.full"),
         np.asarray(world.jax("chol_host")), SOLVE_RTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_counts_are_global_on_every_rank(world, kind):
    """n_perturbed and growth: one value on every rank, the stacked
    engine's at that S, and the JAX engine's."""
    npert = int(world.same_on_every_rank(f"dsol.{kind}.n_perturbed"))
    growth = float(world.same_on_every_rank(f"dsol.{kind}.growth"))
    assert npert == int(world.stacked[f"dsol.{kind}.n_perturbed"])
    assert growth == float(world.stacked[f"dsol.{kind}.growth"])
    Fj = world.jax_factor(kind)
    assert npert == Fj.n_perturbed
    held(growth, Fj.growth, SOLVE_RTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_plan_is_the_same_on_every_rank(world, kind):
    assert str(world.same_on_every_rank(f"dsol.{kind}.digest")) \
        == str(world.stacked[f"dsol.{kind}.digest"])
    assert int(world.same_on_every_rank(f"dsol.{kind}.cross")) \
        == int(world.jax_factor(kind).engine.CROSS)


def test_owner_covers_more_than_one_rank(world):
    owners = world.same_on_every_rank("dsol.lu.owners")
    np.testing.assert_array_equal(owners,
                                  world.stacked["dsol.lu.owners"])
    assert len(owners) > 1 and int(world.ranks[0]["dsol.lu.cross"]) > 1
    if world.S == 4:
        assert len(world.same_on_every_rank("dsol.chol.owners")) > 1


def test_refactorize_is_a_plan_cache_hit(world):
    assert all(bool(r["dsol.refactor.hit"]) for r in world.ranks)


def test_device_engines_run_on_every_rank(world):
    for r in world.ranks:
        assert bool(r["dsol.chol.device"]) and bool(r["dsol.backslash.device"])


@pytest.mark.parametrize("kind", KINDS)
def test_gloo_ranks_run_the_device_solver_eagerly(world, kind):
    """A gloo group stages CUDA tensors through the host, so no rank
    captures its factor and solves as CUDA graphs: each says why (the
    transport), and the stacked CPU run says it holds no CUDA tensors."""
    for r in world.ranks:
        assert "gloo" in str(r[f"dsol.{kind}.refusal"])
    assert "CUDA tensors" in str(world.stacked[f"dsol.{kind}.refusal"])


def test_cholesky_of_an_indefinite_matrix_raises_in_every_rank(world):
    assert all(int(r["dsol.chol_failure.raised"]) == 1
               for r in world.ranks)


@pytest.mark.parametrize("S", (2, 4))
def test_failing_cholesky_spawn_returns_before_its_deadline(S):
    ranks = run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", S,
                      backend="gloo", device="cpu", deadline_s=60,
                      args=("chol_failure", {}))
    assert [int(r["chol_failure.raised"]) for r in ranks] == [1] * S


# -- the dense containers --------------------------------------------------

@pytest.mark.parametrize("name", DENSE_MATRICES)
def test_dense_matrix_against_jax_and_stacked(world, name):
    Mj = world.jax(name)
    rtol = None if name in MOVED else (
        SOLVE_RTOL if name in DENSE_SOLUTIONS else RTOL)
    held(world.rows(f"dense.{name}.local"), np.asarray(Mj.data), rtol)
    held(world.same_on_every_rank(f"dense.{name}.full"), Mj.to_numpy(), rtol)
    np.testing.assert_array_equal(
        world.same_on_every_rank(f"dense.{name}.row_partition"),
        Mj.row_partition)
    held(world.rows(f"dense.{name}.local"),
         world.stacked[f"dense.{name}.local"], rtol)


@pytest.mark.parametrize("name", DENSE_VECTORS)
def test_dense_vector_against_jax_and_stacked(world, name):
    vj = world.jax(name)
    held(world.rows(f"dense.{name}.local"), np.asarray(vj.data), RTOL)
    held(world.same_on_every_rank(f"dense.{name}.full"), vj.to_numpy(), RTOL)
    held(world.rows(f"dense.{name}.local"),
         world.stacked[f"dense.{name}.local"], RTOL)


@pytest.mark.parametrize("name", REDUCTIONS)
def test_dense_reduction_against_jax_and_stacked(world, name):
    got = world.same_on_every_rank(f"dense.{name}")
    held(got, np.asarray(world.jax(name)), RTOL)
    held(got, world.stacked[f"dense.{name}"], RTOL)


def test_dense_transpose_lies_on_the_column_partition(world):
    np.testing.assert_array_equal(
        world.same_on_every_rank("dense.transpose.col_partition"),
        world.jax("transpose").col_partition)


@pytest.mark.parametrize("engine", tuple(dc.SPMM_CASES))
def test_spmm_engine_is_the_same_on_every_rank(world, engine):
    assert str(world.same_on_every_rank(f"dense.spmm_{engine}.engine")) \
        == engine == str(world.stacked[f"dense.spmm_{engine}.engine"])
