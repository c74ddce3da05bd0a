"""Indexing, assignment, blocks, the sparse reductions, ``map_rows`` and
``warmup`` on a torch.distributed process group: one process a shard.

Each world (2 and 4 ranks, gloo, CPU) is spawned once for the module
(``parallel/launch.run_ranks``, a file-store rendezvous and a deadline),
and every rank runs ``tools/dist_checks.assembly_checks`` on
``ht.backend_dist``: vector getindex (slice, step slice, host ids,
``DistVector`` ids) and setindex (scalar, host, ``DistVector`` value,
repeated ids); sparse getindex (slices, ids, ``A[:, k]``, ``A[k, :]``) and
setindex (scalar, scipy, a ``DistSparseMatrix`` value whose entries live
on other ranks, repeats, a row grown to the full width); dense getindex
(``D[k, cols]`` with row k on the last rank) and setindex (a
``DistDenseMatrix`` value); sparse ``cat`` in a 2 x 2 grid, ``blockdiag``,
dense ``cat``, ``vcat_vectors``, ``hcat_vectors``; every sparse reduction;
``map_rows`` over arguments on different partitions and
``mapslices(axis=1)``; ``warmup``; and the KKT assembly at k = 12, m = 30
(``dist_checks.KKT_SMALL``): its ``cat``, submatrices and Dirichlet rows,
then ``tools/kkt.drive``, which holds every step against scipy in each
rank and traces one ``K @ z`` into a file of the rank's own.

Inputs are seeded with numpy (``dist_checks.assembly_inputs``), on a
partition with an empty shard. Each result is held against the JAX package
over a mesh of the same S (the same ``dist_checks.assembly_cases`` run
through ``hpclinalg``) and against the port's stacked backend at that S (a
rank's rows against that row of the stack): structures by their hash,
moved values bit for bit, sums within 1e-12 of the largest entry."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from hpclinalg_torch.parallel.launch import run_ranks
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.utils.profiling import trace_path

torch.set_num_threads(1)

DEADLINE_S = 120
RTOL = 1e-12

# results that are sums: reductions, a column or a row taken as a sum of
# the submatrix, and maps whose function sums
SUMMED = ("sget_col", "sget_col_ids", "sget_row", "norm2", "norm1",
          "norminf", "norm3", "opnorm1", "opnorminf", "sum", "sum0", "sum1",
          "tr", "mean", "map_vec_dense", "map_row", "mapslices_rows",
          "kkt_Kj", "kkt_edit_opnorm1")
MOVED = ("vget_slice", "vget_step", "vget_ids", "vget_vec", "vset_scalar",
         "vset_host", "vset_vec", "vset_repeats", "sget_slice", "sget_step",
         "sget_ids", "sget_vec", "sset_scalar", "sset_scipy", "sset_dist",
         "sset_dist_repeats", "sset_repeats", "sset_grow", "dget_row",
         "dget_rows", "dget_col", "dset_dist", "dset_host", "cat22",
         "blockdiag", "dcat_v", "dcat_h", "vcat_vectors", "hcat_vectors",
         "maximum", "minimum", "map_vertex", "warmup", "kkt_K", "kkt_K11",
         "kkt_Kp", "kkt_Kn", "kkt_edit")
CASES = MOVED + SUMMED


def case_keys(results: dict, name: str) -> list:
    """The keys of one case in a dict of ``assembly_cases`` results."""
    return [k for k in results if k == name or k.startswith(name + ".")]


class World:
    def __init__(self, S, trace_dir):
        self.S = S
        self.trace_dir = str(trace_dir)
        self.ranks = run_ranks(
            "hpclinalg_torch.tools.dist_checks:on_rank", S, backend="gloo",
            device="cpu", deadline_s=DEADLINE_S,
            args=("assembly_checks", {"trace_dir": self.trace_dir}))
        self.stacked = dc.assembly_checks(ht.backend_auto(S, device="cpu"),
                                          trace_dir=self.trace_dir + "_S")
        self._jax = None

    @property
    def jax(self):
        """The JAX package's results, "asm."-prefixed like the ranks'."""
        if self._jax is None:
            res = dc.assembly_cases(hl, hl.backend_auto(nshards=self.S),
                                    dc.assembly_inputs(self.S), jnp.stack)
            self._jax = {f"asm.{k}": v for k, v in res.items()}
        return self._jax

    def rows(self, key):
        """Every rank's rows of ``key``, stacked: the distributed result in
        the stacked layout."""
        return np.concatenate([r[key] for r in self.ranks])

    def same_on_every_rank(self, key):
        vals = [r[key] for r in self.ranks]
        for v in vals[1:]:
            np.testing.assert_array_equal(v, vals[0])
        return vals[0]

    def result(self, key):
        """The group's result of ``key`` in the stacked layout."""
        return self.rows(key) if key.endswith(".local") \
            else self.same_on_every_rank(key)


@pytest.fixture(scope="module", params=(2, 4), ids=("world2", "world4"))
def world(request, tmp_path_factory):
    return World(request.param,
                 tmp_path_factory.mktemp(f"traces{request.param}"))


def held(got, want, exact):
    """``got`` equals ``want`` bit for bit, or within RTOL of the largest
    |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact or got.dtype.kind not in "fc":
        np.testing.assert_array_equal(got, want)
        return
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= RTOL * max(np.max(np.abs(want)) if want.size else 0.0,
                             1e-300), (err, RTOL)


def test_ranks_hold_one_shard_and_import_no_jax(world):
    for r, out in enumerate(world.ranks):
        assert int(out["meta.rank"]) == r and int(out["meta.nlocal"]) == 1
        assert not bool(out["meta.jax"]) and not bool(out["meta.hpclinalg"])


def test_every_case_is_checked(world):
    names = {k[len("asm."):].split(".")[0] for k in world.ranks[0]
             if k.startswith("asm.") and not k.startswith("asm.drive.")}
    assert names == set(CASES)
    assert not set(MOVED) & set(SUMMED)


@pytest.mark.parametrize("name", CASES)
def test_case_against_jax(world, name):
    keys = case_keys(world.jax, f"asm.{name}")
    assert keys and set(keys) == set(case_keys(world.ranks[0],
                                               f"asm.{name}"))
    for key in keys:
        held(world.result(key), world.jax[key], name in MOVED)


@pytest.mark.parametrize("name", CASES)
def test_case_equals_the_stacked_rows(world, name):
    keys = case_keys(world.stacked, f"asm.{name}")
    assert keys
    for key in keys:
        held(world.result(key), world.stacked[key], name in MOVED)


def test_a_value_across_ranks_lands_where_assigned(world):
    """The DistSparseMatrix value of ``sset_dist`` lives on the value's
    uniform partition; A's rows are on a partition with an empty shard, so
    its entries cross ranks, and A equals the scipy assignment."""
    inp = dc.assembly_inputs(world.S)
    ref = inp["R"].tolil()
    ref[np.ix_(inp["srows"], inp["scols"])] = inp["Vs"].toarray()
    ref = ref.tocsr()
    ref.sort_indices()
    got = world.result("asm.sset_dist.local")
    p = inp["p"]
    for s in range(world.S):
        vals = ref[p[s]: p[s + 1]].data
        np.testing.assert_array_equal(got[s, : len(vals)], vals)
        assert not got[s, len(vals):].any(), "nzval padding not zero"


def test_kkt_drive_engines_equal_the_stacked_drive(world):
    for key in ("engine", "k11_engine", "blockdiag_engine"):
        got = str(world.same_on_every_rank(f"asm.drive.{key}"))
        assert got == str(world.stacked[f"asm.drive.{key}"])
    assert str(world.stacked["asm.drive.k11_engine"]) == "dia"


def test_profile_trace_writes_a_file_a_rank(world):
    """On a group each rank's ``profile_trace`` writes its own file, and
    each names the region ``kkt.drive`` annotated; stacked, the one file
    is ``trace.json``."""
    for r in range(world.S):
        path = f"{world.trace_dir}/trace.rank{r}.json"
        with open(path) as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
        assert "kkt_matvec" in names, path
    with open(trace_path(world.trace_dir + "_S",
                         ht.backend_auto(world.S, device="cpu"))) as fh:
        assert "kkt_matvec" in fh.read()
    assert trace_path("d") == "d/trace.json"
