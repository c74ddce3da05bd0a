"""The port on a torch.distributed process group: one process a shard.

Each world (2 and 4 ranks, gloo, CPU) is spawned once for the module
(``parallel/launch.run_ranks``, a file-store rendezvous and a deadline),
and every rank runs ``tools/dist_checks.checks`` on ``ht.backend_dist``:
containers on a partition with an empty shard, the exchange, ``A @ x``
on every engine, the reductions, 20 CG steps, host solves with the
backslash cache, the utilities and the operations of indexing,
assignment, blocks, the sparse reductions, ``map_rows`` and ``warmup``
(``dist_checks.group_ops``). Its results are compared
with the JAX package at the same shard count on the same seeded inputs
(values rtol 1e-12, CG iterates and solves rtol 1e-10; f32 CG at 1e-5 of
the largest entry) and with the port's stacked backend at the same S (a
rank's rows against that row of the stack: data movement and the K1/K3
products exact, everything summed in another order rtol 1e-12)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from hpclinalg.ops.gather import gather_exchange_plan as jax_gather_plan
from hpclinalg.ops.gather import scatter_exchange_plan as jax_scatter_plan
from hpclinalg_torch.parallel.launch import run_ranks
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.tools.dryrun import dryrun_multichip
from hpclinalg_torch.tools.matrices import laplace2d

torch.set_num_threads(1)

DEADLINE_S = 120
# group operations whose results are sums (another order on a group)
GROUP_SUMMED = ("norm", "opnorm", "sum", "row_sum", "tr", "mean")


class World:
    def __init__(self, S):
        self.S = S
        self.ranks = run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", S,
                               backend="gloo", device="cpu",
                               deadline_s=DEADLINE_S, args=("checks", {}))
        self.stacked = dc.checks(ht.backend_auto(S, device="cpu"))
        self.jbe = hl.backend_auto(nshards=S)

    def rows(self, key):
        """Every rank's rows of ``key``, stacked: the distributed result in
        the stacked layout."""
        return np.concatenate([r[key] for r in self.ranks])

    def same_on_every_rank(self, key):
        vals = [r[key] for r in self.ranks]
        for v in vals[1:]:
            np.testing.assert_array_equal(v, vals[0])
        return vals[0]


@pytest.fixture(scope="module", params=(2, 4), ids=("world2", "world4"))
def world(request):
    return World(request.param)


def close(got, want, rtol):
    """max |got - want| <= rtol * max |want| (the card checks' rule)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= rtol * max(np.max(np.abs(want)) if want.size else 0.0,
                             1e-300), (err, rtol)


def test_backend_dist_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        ht.backend_dist(device="cpu")


def test_ranks_hold_one_shard_and_import_no_jax(world):
    for r, out in enumerate(world.ranks):
        assert int(out["meta.rank"]) == r
        assert int(out["meta.world"]) == world.S
        assert int(out["meta.nlocal"]) == 1
        assert not bool(out["meta.jax"]), "a rank imported jax"
        assert not bool(out["meta.hpclinalg"]), "a rank imported hpclinalg"
        assert out["vec.x.local"].shape[0] == 1


VEC_ROWS = ("x", "axpy", "repart", "repart_back", "zeros", "rand",
            "from_local", "deferred")


@pytest.mark.parametrize("name", VEC_ROWS)
def test_vector_rows_equal_the_stacked_rows(world, name):
    key = f"vec.{name}.local"
    np.testing.assert_array_equal(world.rows(key), world.stacked[key])


def test_vector_to_numpy_against_jax(world):
    n, S = 37, world.S
    rng = np.random.default_rng(1)
    xh, yh = rng.standard_normal(n), rng.standard_normal(n)
    p = dc.empty_shard_partition(n, S)
    xj = hl.DistVector.from_global(xh, world.jbe, partition=p)
    yj = hl.DistVector.from_global(yh, world.jbe, partition=p)
    for key in ("vec.x.full", "vec.x.ro", "vec.deferred.full"):
        np.testing.assert_array_equal(world.same_on_every_rank(key),
                                      xj.to_numpy())
    np.testing.assert_array_equal(world.rows("vec.x.local"),
                                  np.asarray(xj.data))
    close(world.same_on_every_rank("vec.axpy.full"),
          (xj + 2.5 * yj).to_numpy(), 1e-12)
    pu = hl.uniform_partition(n, S)
    wj = xj.repartition(pu)
    np.testing.assert_array_equal(world.same_on_every_rank("vec.repart.full"),
                                  wj.to_numpy())
    np.testing.assert_array_equal(world.rows("vec.repart.local"),
                                  np.asarray(wj.data))


REDUCTIONS = ("dot", "norm2", "norm1", "norminf", "sum", "mean", "max",
              "min", "mixed_dot")


@pytest.mark.parametrize("name", REDUCTIONS)
def test_vector_reductions_against_jax(world, name):
    n, S = 37, world.S
    rng = np.random.default_rng(1)
    xh, yh = rng.standard_normal(n), rng.standard_normal(n)
    p = dc.empty_shard_partition(n, S)
    xj = hl.DistVector.from_global(xh, world.jbe, partition=p)
    yj = hl.DistVector.from_global(yh, world.jbe, partition=p)
    want = {"dot": lambda: xj.dot(yj), "norm2": lambda: xj.norm(),
            "norm1": lambda: xj.norm(1), "norminf": lambda: xj.norm(np.inf),
            "sum": lambda: xj.sum(), "mean": lambda: xj.mean(),
            "max": lambda: xj.max(), "min": lambda: xj.min(),
            "mixed_dot": lambda: xj.dot(yj.repartition(
                hl.uniform_partition(n, S)))}[name]()
    got = world.same_on_every_rank(f"vec.{name}")
    close(got, float(want), 1e-12)
    close(got, world.stacked[f"vec.{name}"], 1e-12)


EXCHANGES = ("gather", "gather3", "gather_c", "scatter_add")


@pytest.mark.parametrize("name", EXCHANGES)
def test_exchange_against_jax_and_stacked(world, name):
    S = world.S
    p, xh, wanted, dst, pd = dc.exchange_inputs(37, S, 2)
    xj = hl.DistVector.from_global(xh, world.jbe, partition=p)
    x = np.asarray(xj.data)
    if name == "scatter_add":
        jp = jax_scatter_plan(world.jbe, p, dst, pd)
        want = np.asarray(jp.apply(xj.data, base=jnp.ones((S, jp.out_pad)),
                                   add=True))
    else:
        jp = jax_gather_plan(world.jbe, p, wanted)
        want = np.asarray(jp.apply(xj.data))
        if name == "gather3":
            want = np.asarray(jp.apply(jnp.asarray(
                x[:, :, None] * np.arange(1, 4)))).reshape(want.shape + (3,))
        elif name == "gather_c":
            want = want * (1.0 - 0.5j)
    got = world.rows(f"ex.{name}.local")
    if name == "scatter_add":       # sums: another order of additions
        close(got, want, 1e-12)
        close(got, world.stacked[f"ex.{name}.local"], 1e-12)
    else:                           # moved values are copied: exact
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, world.stacked[f"ex.{name}.local"])


def test_exchange_rides_the_collective(world):
    assert all(bool(r["ex.crosses"]) for r in world.ranks)
    assert world.same_on_every_rank("ex.nmoved") \
        == world.stacked["ex.nmoved"]


ENGINES = ("dia", "ell", "resident", "densify", "segment")


@pytest.mark.parametrize("engine", ENGINES)
def test_spmv_engines_against_jax_and_stacked(world, engine):
    M, _limits = dc.spmv_matrices()[engine]
    xh = np.random.default_rng(4).standard_normal(M.shape[1])
    assert str(world.same_on_every_rank(f"spmv.{engine}.engine")) == engine
    assert str(world.stacked[f"spmv.{engine}.engine"]) == engine
    assert world.same_on_every_rank(f"spmv.{engine}.hash") \
        == world.stacked[f"spmv.{engine}.hash"]
    Aj = hl.DistSparseMatrix.from_scipy(M, world.jbe)
    want = (Aj @ hl.DistVector.from_global(xh, world.jbe)).to_numpy()
    close(world.same_on_every_rank(f"spmv.{engine}.full"), want, 1e-12)
    close(world.same_on_every_rank(f"spmv.{engine}.full"), M @ xh, 1e-12)
    got, ref = world.rows(f"spmv.{engine}.local"), \
        world.stacked[f"spmv.{engine}.local"]
    if engine in ("dia", "resident"):   # K1's and K3's per-row arithmetic
        np.testing.assert_array_equal(got, ref)
    else:
        close(got, ref, 1e-12)


@pytest.mark.parametrize("dtype", (np.float64, np.float32),
                         ids=("f64", "f32"))
def test_cg_iterates_against_jax(world, dtype):
    from __graft_entry__ import _cg_step_fn

    k, S = 16, world.S
    bh = np.random.default_rng(5).standard_normal(k * k)
    be = hl.backend_auto(nshards=S, dtype=dtype)
    Ad = hl.DistSparseMatrix.from_scipy(laplace2d(k).astype(dtype), be,
                                        dtype=dtype)
    b = hl.DistVector.from_global(bh, be, dtype=dtype)
    step, x0 = _cg_step_fn(Ad, be)
    step = jax.jit(step)
    x, r, p = x0.data, b.data, b.data
    for _ in range(20):
        x, r, p = step(x, r, p)
    tag, rtol = np.dtype(dtype).name, 1e-10 if dtype == np.float64 else 1e-5
    close(world.rows(f"cg.{tag}.x.local"), np.asarray(x), rtol)
    close(world.rows(f"cg.{tag}.r.local"), np.asarray(r), rtol)
    close(world.rows(f"cg.{tag}.x.local"),
          world.stacked[f"cg.{tag}.x.local"], rtol)
    close(world.same_on_every_rank(f"cg.{tag}.rnorm"),
          float(jnp.linalg.norm(r)), rtol)


SOLVES = ("ldlt", "ldlt_host", "lu", "lu_t", "lu_st", "bs1", "bs2")


@pytest.mark.parametrize("name", SOLVES)
def test_host_solves_against_jax(world, name):
    k, S = 10, world.S
    L = laplace2d(k)
    rng = np.random.default_rng(4)
    bh = rng.standard_normal(L.shape[0])
    Lu = L.copy()
    Lu.data = Lu.data * (1.0 + 0.2 * rng.random(Lu.nnz))
    be = world.jbe
    A = hl.DistSparseMatrix.from_scipy(L, be)
    b = hl.DistVector.from_global(bh, be)
    if name in ("ldlt", "ldlt_host"):
        want = hl.ldlt(A).solve(b).to_numpy()
    elif name == "lu_st":
        want = hl.lu(hl.DistSparseMatrix.from_scipy(Lu, be)) \
            .solve_transpose(b).to_numpy()
    elif name in ("lu", "lu_t"):
        want = hl.lu(hl.DistSparseMatrix.from_scipy(Lu, be)).solve(
            b, transpose=name == "lu_t").to_numpy()
    else:
        M = L if name == "bs1" else (2.0 * L + sp.eye(L.shape[0])).tocsr()
        want = hl.solve(hl.DistSparseMatrix.from_scipy(M, be), b).to_numpy()
    got = world.same_on_every_rank(f"solve.{name}.full")
    close(got, want, 1e-10)
    close(got, world.stacked[f"solve.{name}.full"], 1e-10)


def test_host_solve_factors_on_rank_0_only(world):
    for r, out in enumerate(world.ranks):
        assert bool(out["solve.root"]) == (r == 0)
        assert bool(out["solve.native"]) == (r == 0)
        # one cache entry, refactorized in place by the second solve
        assert int(out["solve.bs.entries"]) == 1
        assert bool(out["solve.bs.hit"])
    close(world.rows("solve.bs2.local"), world.stacked["solve.bs2.local"],
          1e-10)
    close(world.rows("solve.ldlt.local"), world.stacked["solve.ldlt.local"],
          1e-10)


@pytest.mark.parametrize("kind", ("ldlt", "lu"))
def test_perturbed_pivots_are_rank_0s_on_every_rank(world, kind):
    # rank 0 alone factors; every rank reports its count (a singular
    # graph Laplacian, so a pivot is perturbed)
    got = int(world.same_on_every_rank(f"solve.perturbed.{kind}"))
    assert got == int(world.stacked[f"solve.perturbed.{kind}"]) > 0
    L = laplace2d(10)
    G = (L - sp.diags(np.asarray(L.sum(axis=1)).ravel())).tocsr()
    Aj = hl.DistSparseMatrix.from_scipy(G, world.jbe)
    assert got == getattr(hl, kind)(Aj).n_perturbed


def test_comm_size_rank_and_io0(world):
    for r, out in enumerate(world.ranks):
        assert int(out["util.comm_size"]) == world.S
        assert int(out["util.comm_rank"]) == r
        assert bool(out["util.io0"]) == (r == 0)


def test_to_backend_both_ways(world):
    n, S = 37, world.S
    xh = np.random.default_rng(6).standard_normal(n)
    np.testing.assert_array_equal(world.same_on_every_rank("util.to_one.full"),
                                  xh)
    assert int(world.same_on_every_rank("util.to_one.shards")) == 1
    np.testing.assert_array_equal(world.rows("util.back.local"),
                                  world.stacked["util.back.local"])
    np.testing.assert_array_equal(world.rows("util.back.local"), np.asarray(
        hl.DistVector.from_global(xh, world.jbe).data))
    L = laplace2d(5)
    np.testing.assert_array_equal(
        world.same_on_every_rank("util.sparse_to_one.values"), L.data)
    np.testing.assert_array_equal(world.rows("util.sparse_back.local"),
                                  world.stacked["util.sparse_back.local"])


def test_from_reference_keeps_the_local_shard(world):
    for key in ("util.ref_vec.local", "util.ref_mat.local"):
        np.testing.assert_array_equal(world.rows(key), world.stacked[key])
    assert all(bool(r["util.ref_mat.same_hash"]) for r in world.ranks)
    Aj = hl.DistSparseMatrix.from_scipy(laplace2d(5), world.jbe)
    np.testing.assert_array_equal(world.rows("util.ref_mat.local"),
                                  np.asarray(Aj.nzval))


def test_with_dtype_keeps_the_group(world):
    assert all(bool(r["util.with_dtype.keeps_group"]) for r in world.ranks)
    got = world.rows("util.with_dtype.f32")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, world.stacked["util.with_dtype.f32"])
    n, S = 37, world.S
    xh = np.random.default_rng(6).standard_normal(n)
    jbe = world.jbe.with_dtype(np.float32)
    np.testing.assert_array_equal(got, np.asarray(hl.DistVector.from_global(
        xh, jbe, partition=dc.empty_shard_partition(n, S)).data))


def test_every_group_operation_is_checked(world):
    for out in world.ranks:
        assert {k[len("grp."):].removesuffix(".local") for k in out
                if k.startswith("grp.")} == set(dc.GROUP_OPS)


@pytest.mark.parametrize("op", dc.GROUP_OPS)
def test_group_operation_equals_the_stacked_rows(world, op):
    """Each operation runs on the group, and each rank's rows (or the
    value, the same on every rank) equal the stacked backend's at that S:
    moved values bit for bit, sums rtol 1e-12."""
    key = f"grp.{op}.local"
    if key in world.stacked:
        got, want = world.rows(key), world.stacked[key]
    else:
        key = f"grp.{op}"
        got, want = world.same_on_every_rank(key), world.stacked[key]
    if op in GROUP_SUMMED:
        close(got, want, 1e-12)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", (2, 4))
def test_dryrun_multichip(n):
    out = dryrun_multichip(n, device="cpu", backend="gloo")
    assert float(out["cg_residual"]) < 0.1 * float(out["cg_residual0"])
    assert float(out["solve_residual_float32"]) < 1e-5
    assert float(out["solve_residual_float64"]) < 1e-10
    assert float(out["complex_spmv_rel_err"]) < 1e-3
    assert float(out["complex_lu_residual"]) < 1e-5
    assert float(out["device_ldlt_residual"]) < 1e-5
    assert float(out["device_lu_residual"]) < 1e-5
    assert bool(out["device_ldlt_local_subtrees"])


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a host without a card")
def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", 2,
                  args=("vectors", {}))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(2)


def test_run_ranks_refuses_nccl_on_the_cpu():
    with pytest.raises(ValueError, match="NCCL needs device='cuda'"):
        run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", 2,
                  device="cpu", args=("vectors", {}))


def test_run_ranks_kills_the_ranks_at_its_deadline():
    # a one-second deadline ends before a child has even imported torch
    with pytest.raises(TimeoutError, match="still running"):
        run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", 2,
                  backend="gloo", device="cpu", deadline_s=1,
                  args=("vectors", {}))


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank [01] failed"):
        run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", 2,
                  backend="gloo", device="cpu", deadline_s=DEADLINE_S,
                  args=("no_such_body", {}))
