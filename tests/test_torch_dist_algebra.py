"""The sparse algebra on a torch.distributed process group: one process a
shard.

Each world (2 and 4 ranks, gloo, CPU) is spawned once for the module
(``parallel/launch.run_ranks``, a file-store rendezvous and a deadline),
and every rank runs ``tools/dist_checks.algebra`` on ``ht.backend_dist``:
the transpose and its cache, the lazy products and right division,
``A + B`` across patterns and partitions, both paths of ``add_identity``,
SpGEMM on each engine, ``diag``/``triu``/``tril``/``dropzeros``, the
builders, a sparse repartition and the complex (c128) transpose,
addition and SpGEMM, on a partition with an empty shard. Each result is
held against the port's stacked backend at the same S (a rank's rows
against that row of the stack) and against the JAX package over a mesh of
the same S on the same seeded inputs: data movement bit for bit, sums
(addition, SpGEMM, the products, the solve) within rtol 1e-12 of the
largest entry; structures by their hash."""

import numpy as np
import pytest
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from hpclinalg_torch.parallel.launch import run_ranks
from hpclinalg_torch.tools import dist_checks as dc

torch.set_num_threads(1)

DEADLINE_S = 120
RTOL = 1e-12

# results whose values are copied (moved, cut or filled), never summed
MOVED = ("transpose", "transpose_values", "adjoint", "triu", "tril",
         "dropzeros", "dropzeros_tol", "speye", "spdiagm", "spdiagm_offsets",
         "spzeros", "sprand_dist", "from_local_csr", "from_structure",
         "repartition", "c128_transpose")
SUMMED = ("add", "sub", "add_lazy", "add_identity_fast", "add_identity_slow",
          "spgemm_dia", "spgemm_densify", "spgemm_pairs", "spgemm_chunks",
          "spgemm_lazy", "c128_add", "c128_spgemm")
MATRICES = MOVED + SUMMED
VECTORS = ("At_x", "xt_A", "xt_div_A", "A_x", "diag0", "diag1", "diag-1")
MOVED_VECTORS = ("diag0", "diag1", "diag-1")


def jax_results(inp, S):
    """name -> a function computing the JAX package's result at S shards
    on the inputs of ``dc.algebra``."""
    be = hl.backend_auto(nshards=S)
    bc = hl.backend_auto(nshards=S, dtype=np.complex128)
    p, pu, n = inp["p"], inp["pu"], inp["A"].shape[0]
    M = {k: hl.DistSparseMatrix.from_scipy(inp[k], be, row_partition=p)
         for k in ("R", "A", "Z")}
    M["L"] = hl.DistSparseMatrix.from_scipy(inp["L"], be,
                                            row_partition=inp["pL"])
    M["B"] = hl.DistSparseMatrix.from_scipy(inp["B"], be, row_partition=pu)
    M["Ac"] = hl.DistSparseMatrix.from_scipy(inp["Ac"], bc, row_partition=p)
    M["Bc"] = hl.DistSparseMatrix.from_scipy(inp["Bc"], bc, row_partition=pu)
    x = hl.DistVector.from_global(inp["x"], be, partition=p)
    y = hl.DistVector.from_global(inp["y"], be, partition=p)
    d1 = hl.DistVector.from_global(inp["d1"], be)
    d2 = hl.DistVector.from_global(inp["d2"], be)
    xr = hl.DistVector.from_global(inp["x"][: M["R"].ncols], be)
    Bp = M["B"].repartition(p)
    A_sc = inp["A"]
    parts = [(A_sc[p[s]: p[s + 1]].indptr, A_sc[p[s]: p[s + 1]].indices,
              A_sc[p[s]: p[s + 1]].data) for s in range(S)]
    return {
        "transpose": lambda: M["R"].transpose_materialized(),
        "transpose_values": lambda: (3.0 * M["R"]).transpose_materialized(),
        "adjoint": lambda: M["Ac"].H.materialize(),
        "At_x": lambda: M["R"].T @ x,
        "xt_A": lambda: (x.T @ M["R"]).parent,
        "xt_y": lambda: x.T @ y,
        "xt_div_A": lambda: (x.T / M["A"]).parent,
        "A_x": lambda: M["R"] @ xr,
        "add": lambda: M["A"] + M["B"],
        "sub": lambda: M["A"] - Bp,
        "add_lazy": lambda: M["A"] + Bp.T,
        "add_identity_fast": lambda: M["A"].add_identity(2.5),
        "add_identity_slow": lambda: Bp.add_identity(-1.5),
        "spgemm_dia": lambda: M["L"] @ M["L"],
        "spgemm_densify": lambda: M["A"] @ M["B"],
        "spgemm_pairs": lambda: M["A"] @ M["B"],
        "spgemm_chunks": lambda: M["A"] @ M["B"],
        "spgemm_lazy": lambda: M["R"].T @ M["A"],
        "diag0": lambda: M["L"].diag(0),
        "diag1": lambda: M["L"].diag(1),
        "diag-1": lambda: M["L"].diag(-1),
        "triu": lambda: M["A"].triu(),
        "tril": lambda: M["A"].tril(-1),
        "dropzeros": lambda: M["Z"].dropzeros(),
        "dropzeros_tol": lambda: M["A"].dropzeros(0.5),
        "speye": lambda: hl.speye(n, be, row_partition=p),
        "spdiagm": lambda: hl.spdiagm(x),
        "spdiagm_offsets": lambda: hl.spdiagm((0, x), (1, d1), (-3, d2)),
        "spzeros": lambda: hl.spzeros(n, n + 3, be, row_partition=p),
        "sprand_dist": lambda: hl.sprand_dist(n, n, 0.2, be, seed=7),
        "from_local_csr": lambda: hl.DistSparseMatrix.from_local_csr(
            parts, n, be),
        "from_structure": lambda: hl.DistSparseMatrix.from_structure(
            M["A"].structure, [2.0 * d for _ip, _j, d in parts]),
        "repartition": lambda: M["A"].repartition(pu),
        "c128_transpose": lambda: M["Ac"].transpose_materialized(),
        "c128_add": lambda: M["Ac"] + M["Bc"],
        "c128_spgemm": lambda: M["Ac"] @ M["Bc"].repartition(p),
    }


class World:
    def __init__(self, S):
        self.S = S
        self.ranks = run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", S,
                               backend="gloo", device="cpu",
                               deadline_s=DEADLINE_S, args=("algebra", {}))
        self.stacked = dc.algebra(ht.backend_auto(S, device="cpu"))
        self.inp = dc.algebra_inputs(S)
        self._jax_fns = None
        self._jax = {}

    def rows(self, key):
        """Every rank's rows of ``key``, stacked: the distributed result in
        the stacked layout."""
        return np.concatenate([r[f"alg.{key}"] for r in self.ranks])

    def same_on_every_rank(self, key):
        vals = [r[f"alg.{key}"] for r in self.ranks]
        for v in vals[1:]:
            np.testing.assert_array_equal(v, vals[0])
        return vals[0]

    def jax(self, name):
        if name not in self._jax:
            if self._jax_fns is None:
                self._jax_fns = jax_results(self.inp, self.S)
            self._jax[name] = self._jax_fns[name]()
        return self._jax[name]


@pytest.fixture(scope="module", params=(2, 4), ids=("world2", "world4"))
def world(request):
    return World(request.param)


def held(got, want, exact):
    """``got`` equals ``want`` bit for bit, or within RTOL of the largest
    |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= RTOL * max(np.max(np.abs(want)) if want.size else 0.0,
                             1e-300), (err, RTOL)


def test_ranks_hold_one_shard_and_import_no_jax(world):
    for r, out in enumerate(world.ranks):
        assert int(out["meta.rank"]) == r and int(out["meta.nlocal"]) == 1
        assert not bool(out["meta.jax"]) and not bool(out["meta.hpclinalg"])


@pytest.mark.parametrize("name", MATRICES)
def test_matrix_rows_equal_the_stacked_rows(world, name):
    assert str(world.same_on_every_rank(f"{name}.hash")) \
        == str(world.stacked[f"alg.{name}.hash"])
    held(world.rows(f"{name}.local"), world.stacked[f"alg.{name}.local"],
         name in MOVED)


@pytest.mark.parametrize("name", MATRICES)
def test_matrix_against_jax(world, name):
    Mj = world.jax(name)
    assert str(world.same_on_every_rank(f"{name}.hash")) == Mj.hash
    held(world.rows(f"{name}.local"), np.asarray(Mj.nzval), name in MOVED)


@pytest.mark.parametrize("name", VECTORS)
def test_vector_against_jax_and_stacked(world, name):
    exact = name in MOVED_VECTORS
    vj = world.jax(name)
    held(world.rows(f"{name}.local"), np.asarray(vj.data), exact)
    held(world.rows(f"{name}.local"), world.stacked[f"alg.{name}.local"],
         exact)
    held(world.same_on_every_rank(f"{name}.full"), vj.to_numpy(), exact)


def test_xt_y_is_all_reduced(world):
    got = world.same_on_every_rank("xt_y")
    held(got, float(world.jax("xt_y")), False)
    held(got, world.stacked["alg.xt_y"], False)
    held(got, world.inp["x"] @ world.inp["y"], False)


@pytest.mark.parametrize("engine", tuple(dc.SPGEMM_CASES))
def test_spgemm_engine_is_the_same_on_every_rank(world, engine):
    want = "pairs" if engine == "chunks" else engine
    assert str(world.same_on_every_rank(f"spgemm_{engine}.engine")) == want
    assert str(world.stacked[f"alg.spgemm_{engine}.engine"]) == want
    nchunks = int(world.same_on_every_rank(f"spgemm_{engine}.nchunks"))
    assert nchunks == int(world.stacked[f"alg.spgemm_{engine}.nchunks"])
    assert (nchunks > 1) == (engine == "chunks")


@pytest.mark.parametrize("flag", ("transpose.cached_both_ways",
                                  "transpose.plan_reused",
                                  "add_identity_fast.shares_structure"))
def test_cached_plans_on_every_rank(world, flag):
    assert all(bool(r[f"alg.{flag}"]) for r in world.ranks)
    assert bool(world.stacked[f"alg.{flag}"])
