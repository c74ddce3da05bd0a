"""One shard a process on the card (``ht.backend_dist`` over a
``torch.distributed`` group, ranks started by
``parallel.launch.run_ranks``), each rank held against the same body run
stacked at that shard count in this process. Three arrangements: NCCL at
world 1; gloo at world 4 with the four ranks sharing the card (every
collective staged through the host: a test arrangement, not a
deployment); NCCL at world = device count, which skips on one card. An
arrangement's ranks are spawned once and run the four bodies in turn
(``dist_checks.bodies``); each test reads its body's results.

The bodies are ``tools/dist_checks``': ``card`` (the main path at 10^6
rows: K1, K2 with its gather mode and tail, K3, in f64, f32 and c128, CG,
the ridge assembly, host solves), ``solvers`` (the device Cholesky of
laplace2d(512), the indefinite LDLᵀ, the LU and a c128 LDLᵀ at 256², the
multi-response ridge), ``assembly`` (``tools/kkt.drive`` at k = 1000,
m = 10⁴, every step held against scipy in the rank) and ``entry_steps``
(20 raw CG steps of ``entry.cg_step_fn`` on laplace2d(1000), captured as
a CUDA graph over NCCL; ``capture`` must refuse a gloo group).

This file imports no JAX, so the card runs it with

    python -m pytest --noconftest -m card tests/test_torch_card_groups.py

Every test needs a CUDA device and skips without one.
"""

import json
import os

import numpy as np
import pytest
import torch

import hpclinalg_torch as ht
from hpclinalg_torch.ops.spmv import get_spmv_plan
from hpclinalg_torch.parallel.launch import run_ranks
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.tools import kkt
from hpclinalg_torch.tools.matrices import RIDGE_LAMBDA

SEED = 0
K, N = 1000, 1_000_000
RIDGE = (1_000_000, 16_384, RIDGE_LAMBDA)
BODY = "hpclinalg_torch.tools.dist_checks:on_rank"
ARRANGEMENTS = [("nccl", 1), ("gloo", 4), ("nccl", "all")]
IDS = ["nccl-1", "gloo-4", "nccl-all"]
# ``card``'s depth: the host ldlt's laplace2d(128), and the ridge's CG steps
# on N, whose condition number near 3 takes the residual below 1e-10 in
# about 20
CARD_KW = {"k": K, "n": N, "ridge_shape": RIDGE, "k_solve": 128,
           "ridge_steps": 30, "seed": SEED}
SOLVERS_KW = {"k": 512, "k_small": 256, "ridge_shape": RIDGE, "ycols": 64,
              "seed": SEED}
KKT_M, KKT_SEED = 10_000, 30
ENTRY_KW = {"k": K, "seed": SEED + 15, "dtypes": ("float64",)}
# the arrangement's spawn, inputs and the four bodies
DEADLINE_S = 1000
# ``card``'s results held bit for bit besides the exchanges and the
# products of K1 and K3 (the same kernel on the same shard's tables): the
# moved values of the ridge assembly
MOVED = ("ridge.At.local", "ridge.At_c128.local", "ridge.triu.local",
         "ridge.diag.local")
ENGINES = {"lap": "dia", "lap_f32": "dia", "random8": "ell",
           "power_law": "ell", "N": "resident", "helm": "dia",
           "random8_c128": "ell", "N_c128": "resident"}
# the ridge's checks against scipy in every rank: the largest relative
# error each may have
RIDGE_TOL = {"N_rel_err": 1e-12, "solve_res": 1e-10, "Ax_rel_err": 1e-12}
# the residual each of ``solvers``' solves may have in every rank
SOLVER_RES = {"chol_res": 1e-10, "ldl_res": 1e-8, "lu_res": 1e-9,
              "lu_t_res": 1e-9, "c128_res": 1e-10,
              "ridge_multi_res": 1e-10, "ridge_res": 1e-10}
# ``solvers``' results that are sums (the SpMM, the dense transpose's
# product), held to 1e-12; the rest are solutions, held to 1e-10 (the
# cross and top sums run in another order)
SUMMED = ("ridge.R", "ridge.G")
FACTORIZATIONS = ("chol", "ldl", "lu", "c128", "ridge_chol")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def world_of(world):
    if world != "all":
        return world
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("NCCL over every card needs two cards or more")
    return count


def stacked(cache, S, make):
    """``make(S)`` once for each S of the module."""
    if S not in cache:
        cache[S] = make(S)
        torch.cuda.empty_cache()
    return cache[S]


def close(got, want, rtol):
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= rtol * max(scale, 1e-300), (err, rtol, scale)


def one_shard_no_jax(out):
    assert int(out["meta.nlocal"]) == 1 and not bool(out["meta.jax"])


@pytest.fixture(scope="module")
def group(card, tmp_path_factory):
    """(the ranks' results, the assembly's trace directory) of an
    arrangement: ``card``, ``solvers``, ``assembly`` and ``entry_steps``
    (captured over NCCL, refused on gloo) in every rank, once."""
    cache = {}

    def ranks(transport, world):
        if (transport, world) not in cache:
            trace_dir = str(tmp_path_factory.mktemp(f"kkt_{transport}"))
            runs = [("card", CARD_KW), ("solvers", SOLVERS_KW),
                    ("assembly", {"k": K, "m": KKT_M, "seed": KKT_SEED,
                                  "trace_dir": trace_dir}),
                    ("entry_steps", dict(ENTRY_KW,
                                         graphed=transport == "nccl"))]
            cache[transport, world] = (run_ranks(
                BODY, world, backend=transport, device="cuda",
                deadline_s=DEADLINE_S, args=("bodies", {"runs": runs})),
                trace_dir)
        return cache[transport, world]
    yield ranks
    cache.clear()


@pytest.fixture(scope="module")
def mats(card):
    return dc.card_matrices(K, N, RIDGE, SEED)


@pytest.fixture(scope="module")
def card_refs(card, mats):
    cache = {}
    yield lambda S: stacked(cache, S, lambda S: dc.card(
        ht.backend_auto(S, device=card), mats=mats, **CARD_KW))
    cache.clear()


@pytest.mark.card
@pytest.mark.parametrize("transport, world", ARRANGEMENTS, ids=IDS)
def test_main_path(card, card_refs, group, transport, world):
    """``card`` in every rank against the stacked run: the same engines
    (c128 N on one shard is over K3's cap and takes K2), data movement and
    the K1 and K3 products bit for bit, the rest to the rtol of their
    type; the ridge's checks against scipy; K1, K2, its gather mode and
    K3 launched in every rank."""
    world = world_of(world)
    ref = card_refs(world)
    ranks = group(transport, world)[0]
    for r, out in enumerate(ranks):
        one_shard_no_jax(out)
        assert int(out["card.solve.bs.entries"]) == 1
        for name, engine in ENGINES.items():
            if name == "N_c128" and world == 1:
                engine = "ell"
            assert str(out[f"card.{name}.engine"]) == engine \
                == str(ref[f"card.{name}.engine"]), name
        assert str(out["card.ridge.spgemm.engine"]) == "pairs" \
            == str(ref["card.ridge.spgemm.engine"])
        assert int(out["card.ridge.spgemm.nchunks"]) \
            == int(ref["card.ridge.spgemm.nchunks"])
        assert bool(out["card.check.ridge_N_pattern"])
        assert bool(out["card.check.ridge_refit_reused"])
        for key, tol in RIDGE_TOL.items():
            assert float(out[f"card.check.ridge_{key}"]) <= tol, key
        close(out["card.ridge.C2.local"], 2.25 * out["card.ridge.C.local"],
              1e-12)
        for key, want in ref.items():
            if key.startswith(("card.launches.", "card.check.")) \
                    or want.dtype.kind not in "fc":
                continue
            got = out[key]
            if key.endswith(".local"):
                want = want[r: r + 1]
            name = key[len("card."):]
            prod, _, rest = name.partition(".")
            if name in MOVED or ".exchange." in name or (
                    rest.startswith("y.") and str(
                        ref[f"card.{prod}.engine"]) in ("dia", "resident")):
                assert np.array_equal(got, want), name
            else:
                # a sum in another order: the rtol of its parts' type
                close(got, want, 1e-5 if got.dtype in (np.float32,
                                                       np.complex64)
                      else 1e-12)
        assert all(int(out[f"card.launches.{k}"]) >= 1
                   for k in dc.LAUNCH_COUNTERS)


@pytest.fixture(scope="module")
def solver_refs(card, mats):
    ridge = {k: mats[k] for k in ("design", "design_b", "N")}
    cache = {}
    yield lambda S: stacked(cache, S, lambda S: dc.solvers(
        ht.backend_auto(S, device=card), mats=ridge, **SOLVERS_KW))
    cache.clear()


@pytest.mark.card
@pytest.mark.parametrize("transport, world", ARRANGEMENTS, ids=IDS)
def test_device_solver(card, solver_refs, group, transport, world):
    """``solvers`` in every rank against the stacked run: solutions to
    1e-10 and sums to 1e-12 of their largest entry, the same n_perturbed,
    growth and plan digest, the residuals within SOLVER_RES, the device
    engine, K1, K2, its gather mode, K3 and the LDLᵀ's leaf launched;
    CUDA graphs over NCCL (the collectives captured), eager on gloo (the
    group refused by the capture); at gloo world 4 the Cholesky's
    subtrees cover every rank."""
    world = world_of(world)
    ref = solver_refs(world)
    ranks = group(transport, world)[0]
    for r, out in enumerate(ranks):
        one_shard_no_jax(out)
        assert bool(out["sol.chol.device"]) and bool(out["sol.ridge.device"])
        for key, tol in SOLVER_RES.items():
            assert float(out[f"sol.check.{key}"]) <= tol, key
        for kind in FACTORIZATIONS:
            for stat in ("n_perturbed", "growth", "digest"):
                key = f"sol.{kind}.{stat}"
                assert str(out[key]) == str(ref[key]), key
        for key, want in ref.items():
            if not key.endswith((".local", ".full")):
                continue
            if key.endswith(".local"):
                want = want[r: r + 1]
            name = key[len("sol."):].rsplit(".", 1)[0]
            close(out[key], want, 1e-12 if name in SUMMED else 1e-10)
        assert all(int(out[f"sol.launches.{k}"]) >= 1
                   for k in dc.LAUNCH_COUNTERS + dc.LDL_LAUNCH_COUNTERS)
    refusals = {str(r[f"sol.{kind}.refusal"]) for r in ranks
                for kind in FACTORIZATIONS}
    if transport == "nccl":
        assert refusals == {""}
    else:
        assert all("gloo" in why for why in refusals)
    if world == 4:
        assert ranks[0]["sol.chol.owners"].tolist() == list(range(world))
        assert int(ranks[0]["sol.chol.cross"]) > 1


@pytest.fixture(scope="module")
def kkt_engines(card):
    """The SpMV engines of the assembly's products run stacked at S: K @ z,
    K[0:n, 0:n] @ x and blockdiag(A, A) @ [x; x]."""
    I = kkt.Inputs(K, KKT_M, KKT_SEED)
    cache = {}

    def make(S):
        be = ht.backend_auto(S, dtype=np.float64, device=card)
        parts = kkt.blocks(be, I)
        Kd = ht.cat(*parts, dims=(2, 2))
        z = ht.DistVector.from_global(I.z, be)
        x = ht.DistVector.from_global(I.x, be)
        return {"engine": get_spmv_plan(Kd, z).engine(torch.float64),
                "k11_engine": get_spmv_plan(Kd[0:I.n, 0:I.n], x)
                .engine(torch.float64),
                "blockdiag_engine": get_spmv_plan(
                    ht.blockdiag(parts[0], parts[0]),
                    ht.vcat_vectors(x, x)).engine(torch.float64)}
    yield lambda S: stacked(cache, S, make)
    cache.clear()


@pytest.mark.card
@pytest.mark.parametrize("transport, world", ARRANGEMENTS, ids=IDS)
def test_kkt_assembly(card, kkt_engines, group, transport, world):
    """``assembly`` in every rank, each step held against scipy there: the
    engines of the stacked run at that S; K1, K2 and its gather mode
    launched; the rank's trace names ``kkt_matvec`` and the launch range
    of K @ z's kernel."""
    world = world_of(world)
    want = kkt_engines(world)
    ranks, trace_dir = group(transport, world)
    for r, out in enumerate(ranks):
        one_shard_no_jax(out)
        engines = {e: str(out[f"asm.{e}"]) for e in want}
        assert engines == want
        n = {k: int(out[f"asm.launches.{k}"]) for k in dc.LAUNCH_COUNTERS}
        assert n["dia"] >= 1 and n["ell"] >= 1 and n["gather"] >= 1, n
        with open(os.path.join(trace_dir, f"trace.rank{r}.json")) as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
        # densify and segment launch no kernel of this repo: no name
        kn = kkt.ENGINE_KERNELS.get(engines["engine"], "<no kernel>")
        assert "kkt_matvec" in names and any(kn in nm for nm in names)


@pytest.fixture(scope="module")
def entry_refs(card):
    cache = {}
    yield lambda S: stacked(cache, S, lambda S: dc.entry_steps(
        ht.backend_auto(S, device=card), graphed=True, **ENTRY_KW))
    cache.clear()


@pytest.mark.card
@pytest.mark.parametrize("transport, world", ARRANGEMENTS, ids=IDS)
def test_cg_step_on_a_group(card, entry_refs, group, transport, world):
    """20 raw CG steps in every rank: over NCCL captured (the exchange and
    the all_reduces in the graph) and replayed bit for bit against the
    eager steps, on gloo refused by ``capture``; x, r and p within 1e-10
    of the same steps stacked; K1 launched and, across ranks, K2's gather
    mode; each of the step's vector kernels once a step."""
    world = world_of(world)
    ref = entry_refs(world)
    ranks = group(transport, world)[0]
    for r, out in enumerate(ranks):
        one_shard_no_jax(out)
        assert str(out["entry.float64.engine"]) == "dia"
        if transport == "nccl":
            assert bool(out["entry.float64.graphed_equal"])
        else:
            assert "gloo" in str(out["entry.float64.refused"])
        for v in "xrp":
            close(out[f"entry.float64.{v}.local"],
                  ref[f"entry.float64.{v}.local"][r: r + 1], 1e-10)
        n = {k: int(out[f"entry.launches.float64.{k}"])
             for k in dc.LAUNCH_COUNTERS + dc.CG_LAUNCH_COUNTERS}
        assert n["dia"] >= 1 and (world == 1 or n["gather"] >= 1), n
        assert len({n[k] for k in dc.CG_LAUNCH_COUNTERS}) == 1
        assert n["cg_dots"] >= 20
