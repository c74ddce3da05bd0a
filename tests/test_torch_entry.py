"""The compiled CG step of the port (``hpclinalg_torch/entry.py``) against
the JAX package's entry point (``__graft_entry__``) on the CPU.

``cg_step_fn``'s raw step goes against ``_cg_step_fn`` jitted on the CPU
mesh, after 1, 5 and 20 steps, at the shard counts of ``conftest.py``, in
f64 (rtol 1e-10) and f32 (rtol 1e-5, CG's rounding in another summation
order), on laplace2d(16) (the DIA engine, K1's plain version) and on a
seeded SPD matrix off the DIA path (a permuted laplace2d(24) with a small
arrow row, whose 576 entries overflow the ELL width into the COO tail)
on the densify, ELL, resident and segment engines through their plain
versions, where the JAX step takes its segment sum. The raw step also
goes against the public-API CG (``dist_checks.api_cg``, rtol 1e-12);
``entry(device="cpu")`` against the JAX ``entry()``; and on 2 and 4 gloo
ranks (``dist_checks.entry_steps``) every rank's 20 raw steps against the
stacked rows and the JAX step, with ``capture`` refusing the gloo group.
The captured step's calls (``utils/graphs.CapturedStep``) run on the CPU
with a stand-in graph (``standin_graphs``) whose replay reruns the
recorded call and writes its results into the tensors the record
returned, in place, as a CUDA graph's replay does. Tolerances are
relative to the largest entry of the reference. (In f32
the two steps' rounding, in other summation orders, grows in r as CG
shrinks it: after 20 steps on a permuted laplace2d(16) off the DIA path
it reached 1.2e-5 of max |r|; the off-DIA matrix is 24² so that the
residual stays near 3 % of b, where it is 3e-6.)
"""

from functools import lru_cache

import jax
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg as hl
import hpclinalg_torch as ht
from __graft_entry__ import _cg_step_fn
from __graft_entry__ import entry as jax_entry
from hpclinalg_torch import entry as te
from hpclinalg_torch.ops import spmv as tspmv
from hpclinalg_torch.parallel.launch import run_ranks
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.tools.matrices import laplace2d
from hpclinalg_torch.utils import graphs

torch.set_num_threads(1)

SHARDS = (1, 4, 8)          # conftest.CONFIGS' shard counts
STEPS = (1, 5, 20)
DTYPES = (np.float64, np.float32)
RTOL = {np.float64: 1e-10, np.float32: 1e-5}
K = 16                      # laplace2d(K); entry_steps' default too
SPD_K = 24                  # the off-DIA matrix: a permuted laplace2d(SPD_K)
SEED = 5                    # b's seed, as in entry_steps
DEADLINE_S = 120
# each engine and the ops/spmv.py limits its plan is built under; the
# segment engine is the fallback of a plan with no ELL layout
ENGINES = {"dia": {}, "densify": {}, "ell": {"DENSE_MAX_ELEMS": 0},
           "resident": {"DENSE_MAX_ELEMS": 0, "MIN_NNZ": 0,
                        "MAX_ELL_BLOWUP": 16.0},
           "segment": {"DENSE_MAX_ELEMS": 0}}


def close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want))
    assert err <= rtol * np.max(np.abs(want)), (err, rtol)


@lru_cache(maxsize=None)
def spd_off_dia(seed=7):
    """A permuted laplace2d(SPD_K) plus a symmetric arrow of 10⁻³-scaled
    normals in row and column 0: SPD (the arrow's norm is under the
    Laplacian's least eigenvalue), not a few diagonals, and its first row
    longer than the ELL width."""
    rng = np.random.default_rng(seed)
    n = SPD_K * SPD_K
    q = rng.permutation(n)
    arrow = sp.csr_matrix((1e-3 * rng.standard_normal(n),
                           (np.zeros(n, np.int64), np.arange(n))),
                          shape=(n, n))
    return (laplace2d(SPD_K)[q][:, q] + arrow + arrow.T).tocsr()


def matrix(engine):
    return laplace2d(K) if engine == "dia" else spd_off_dia()


def rhs(n):
    return np.random.default_rng(SEED).standard_normal(n)


@lru_cache(maxsize=None)
def jax_iterates(dtype, S, dia):
    """(x, r, p) after each of 20 steps of the jitted JAX step."""
    be = hl.backend_auto(nshards=S, dtype=dtype)
    M = laplace2d(K) if dia else spd_off_dia()
    Aj = hl.DistSparseMatrix.from_scipy(M, be, dtype=dtype)
    bj = hl.DistVector.from_global(rhs(M.shape[0]), be, dtype=dtype)
    step, x0 = _cg_step_fn(Aj, be)
    step = jax.jit(step)
    out, args = [], (x0.data, bj.data, bj.data)
    for _ in range(max(STEPS)):
        args = step(*args)
        out.append(tuple(np.asarray(a) for a in args))
    return out


def port_step(dtype, S, engine):
    """(cg_step, x0, b) on the CPU with the plan built under ``engine``'s
    limits (the plan cache is cleared before and after, so no other test
    finds a plan built under lowered limits)."""
    be = ht.backend_auto(S, dtype=dtype, device="cpu")
    M = matrix(engine)
    no_ell = {"_build_ell": lambda self, A: None} if engine == "segment" \
        else {}
    ht.clear_plan_cache("vector_plan")
    try:
        with dc.patched(tspmv, **ENGINES[engine]), \
                dc.patched(tspmv.SpMVPlan, **no_ell):
            A = ht.DistSparseMatrix.from_scipy(M, be, dtype=dtype)
            step, x0 = te.cg_step_fn(A, be)
    finally:
        ht.clear_plan_cache("vector_plan")
    assert step.engine == engine
    assert (step.plan.offsets is not None) == (engine == "dia")
    if engine in ("ell", "resident"):
        assert step.plan.ell_Tpad > 0, "the arrow row has no COO tail"
    return step, x0, A, ht.DistVector.from_global(rhs(M.shape[0]), be,
                                                  dtype=dtype)


@lru_cache(maxsize=None)
def port_iterates(dtype, S, engine):
    step, x0, _, b = port_step(dtype, S, engine)
    out, args = [], (x0.data, b.data, b.data)
    for _ in range(max(STEPS)):
        args = step(*args)
        out.append(tuple(a.numpy().copy() for a in args))
    return out


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_raw_step_against_jax(dtype, S, engine, steps):
    got = port_iterates(dtype, S, engine)[steps - 1]
    want = jax_iterates(dtype, S, engine == "dia")[steps - 1]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        close(g, w, RTOL[dtype])


@pytest.mark.parametrize("engine", list(ENGINES))
@pytest.mark.parametrize("S", SHARDS)
def test_raw_step_against_public_cg(S, engine):
    step, x0, A, b = port_step(np.float64, S, engine)
    x, r, p = x0.data, b.data, b.data
    for _ in range(20):
        x, r, p = step(x, r, p)
    xa, ra = dc.api_cg(A, b, 20)
    close(x, xa.data, 1e-12)
    close(r, ra.data, 1e-12)


def test_raw_step_keeps_its_arguments_and_the_padding():
    # 576 rows on 5 shards: each holds 115 or 116 in 120 slots
    step, x0, _, b = port_step(np.float64, 5, "ell")
    assert b.L * 5 > b.n
    args = (x0.data.clone(), b.data.clone(), b.data.clone())
    outs = step(*args)
    assert all(torch.equal(a, c) for a, c in zip(args, (x0.data, b.data,
                                                          b.data)))
    mask = b.mask()
    for o in outs:
        assert not bool(o[~mask].any())


@pytest.mark.parametrize("engine", list(ENGINES))
def test_raw_step_in_place_equals_the_new_tensors(engine):
    """The form ``capture`` records: the results written into x, r and p
    themselves, bit for bit the tensors the step returns."""
    step, x0, _, b = port_step(np.float64, 4, engine)
    new = (x0.data, b.data, b.data)
    own = tuple(t.clone() for t in new)
    for _ in range(5):
        new = step(*new)
        assert all(a is c for a, c in zip(step(*own, out=own), own))
        for a, c in zip(new, own):
            assert torch.equal(a, c)


def test_entry_on_the_cpu_equals_jax_entry():
    fn, args = te.entry(device="cpu")
    jfn, jargs = jax_entry()
    assert [tuple(a.shape) for a in args] == [a.shape for a in jargs] \
        == [(1, 4096)] * 3
    assert all(a.dtype == torch.float32 for a in args)
    assert all(a.dtype == np.float32 for a in jargs)
    for a, j in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    assert fn.engine == "dia"
    for g, w in zip(fn(*args), jax.jit(jfn)(*jargs)):
        close(g.numpy(), np.asarray(w), 1e-5)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.entry()
    fn, args = te.entry(device="cpu")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        te.capture(fn, args)


def test_capture_refuses_what_is_not_a_cuda_tensor():
    fn, args = te.entry(device="cpu")
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        te.capture(fn, ())
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        te.capture(fn, tuple(a.numpy() for a in args))


class StandInGraph:
    """A CUDA graph's stand-in on the CPU. The record runs ``fn`` once, as
    a capture runs its Python, and fills the floating tensors it returned
    with NaN (a captured graph's outputs hold nothing before a replay);
    ``replay`` reruns ``fn`` and writes its results into those tensors in
    place."""

    def __init__(self, fn):
        self.fn, self.replays = fn, 0
        self.out = fn()
        for t in _tensors(self.out):
            if t.is_floating_point() or t.is_complex():
                t.fill_(float("nan"))

    def replay(self):
        # a replay runs no wrapper: each kernel's count is the
        # CapturedStep's, held at the record
        self.replays += 1
        held, graphs._held = graphs._held, {}
        try:
            outs = self.fn()
        finally:
            graphs._held = held
        for dst, src in zip(_tensors(self.out), _tensors(outs)):
            if dst is not src:
                dst.copy_(src)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _tensors(x)]


def standin_graphs(monkeypatch) -> list:
    """``utils/graphs``' recording seam (``warm_up``, ``record``) and its
    CUDA check patched for the CPU: returns the list that every record
    appends its StandInGraph to."""
    made = []

    def record(fn, device):
        made.append(StandInGraph(fn))
        return made[-1], made[-1].out, {"capture_s": 0.0,
                                        "instantiate_s": 0.0}

    def warm_up(fn, device):
        return fn()

    monkeypatch.setattr(graphs, "record", record)
    monkeypatch.setattr(graphs, "warm_up", warm_up)
    monkeypatch.setattr(graphs, "_device_refusal", lambda tensors: None)
    return made


def captured_entry(monkeypatch):
    """(fn, args, step): ``entry(device="cpu")``'s step, its arguments and
    the step captured over a stand-in graph, called once on the arguments
    so that its static tensors hold the first step's results."""
    made = standin_graphs(monkeypatch)
    fn, args = te.entry(device="cpu")
    step = te.capture(fn, args)
    assert isinstance(step, te.CapturedStep) and made == [step.graph]
    out = step(*args)
    assert all(o is s for o, s in zip(out, step.static))
    for a, b in zip(out, fn(*args)):
        assert torch.equal(a, b)
    return fn, args, step


def test_captured_step_takes_permuted_static_tensors(monkeypatch):
    """``step(r, x, p)`` on the step's own static tensors: each argument
    shares storage with the static tensor of another position, so the
    copies must not overwrite what a later copy reads."""
    fn, _, step = captured_entry(monkeypatch)
    x, r, p = step.static
    want = fn(r.clone(), x.clone(), p.clone())
    got = step(r, x, p)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # a view of another position's static tensor, and a repeated argument
    x, r, p = step.static
    want = fn(r.clone(), r.clone(), x.clone())
    got = step(r[:], r, x)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ("shape", "dtype", "device", "type"))
def test_captured_step_refuses_another_shape_or_dtype(monkeypatch, bad):
    _, args, step = captured_entry(monkeypatch)
    x, r, p = args
    wrong = {"shape": torch.zeros((1, 1), dtype=r.dtype),
             "dtype": r.to(torch.float64),
             "device": torch.zeros(r.shape, dtype=r.dtype, device="meta"),
             "type": r.numpy()}[bad]
    replays = step.graph.replays
    with pytest.raises(ValueError, match="argument 1: the step was captured"):
        step(x, wrong, p)
    assert step.graph.replays == replays


def test_captured_step_chained_on_its_outputs_copies_nothing(monkeypatch):
    """``x, r, p = step(x, r, p)`` on the step's own outputs replays with
    no copy and no clone: the step writes its results into its inputs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    fn, args, step = captured_entry(monkeypatch)
    want = args
    for _ in range(3):
        want = fn(*want)

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.__name__)
            return func(*args, **(kwargs or {}))

    step.graph.fn = lambda: step.static      # a replay that runs no op
    x, r, p = step(*args)
    step.graph.fn = lambda: fn(*step.static, out=step.static)
    for _ in range(3):
        x, r, p = step(x, r, p)
    for a, b in zip((x, r, p), want):
        assert torch.equal(a, b)
    step.graph.fn = lambda: step.static
    ops = Ops()
    with ops:
        out = step(x, r, p)
    assert out is step.out and ops.names == [], ops.names


def test_captured_step_counts_the_launches_that_ran(monkeypatch):
    """A wrapper's count (``graphs.count_launch``) is the number of times
    its kernel ran: the warm-up's launch counts at once, the capture's is
    held for the graph and added at every replay."""
    standin_graphs(monkeypatch)

    def kernel(t):
        graphs.count_launch(kernel)
        return t * 2

    kernel.launches = 0
    step = graphs.CapturedStep(lambda t: kernel(kernel(t)), (torch.ones(3),))
    assert kernel.launches == 2 and step.held == {kernel: 2}
    for _ in range(3):
        out = step(torch.ones(3))
    assert kernel.launches == 8 and torch.equal(out, torch.full((3,), 4.0))
    assert graphs._held is None


class World:
    def __init__(self, S):
        self.S = S
        self.ranks = run_ranks("hpclinalg_torch.tools.dist_checks:on_rank", S,
                               backend="gloo", device="cpu",
                               deadline_s=DEADLINE_S,
                               args=("entry_steps", {}))
        self.stacked = dc.entry_steps(ht.backend_auto(S, device="cpu"))

    def rows(self, key):
        return np.concatenate([r[key] for r in self.ranks])


@pytest.fixture(scope="module", params=(2, 4), ids=("world2", "world4"))
def world(request):
    return World(request.param)


@pytest.mark.parametrize("dtype", DTYPES, ids=("f64", "f32"))
def test_rank_steps_equal_the_stacked_rows_and_jax(world, dtype):
    tag = np.dtype(dtype).name
    want = jax_iterates(dtype, world.S, True)[-1]
    for i, v in enumerate("xrp"):
        got = world.rows(f"entry.{tag}.{v}.local")
        close(got, world.stacked[f"entry.{tag}.{v}.local"], RTOL[dtype])
        close(got, want[i], RTOL[dtype])


def test_capture_refuses_the_gloo_group(world):
    for out in world.ranks:
        for tag in ("float64", "float32"):
            assert "gloo" in str(out[f"entry.{tag}.refused"])
    assert "CUDA tensors" in str(world.stacked["entry.float64.refused"])


def test_ranks_run_the_dia_engine_without_jax(world):
    for r, out in enumerate(world.ranks):
        assert int(out["meta.rank"]) == r and int(out["meta.nlocal"]) == 1
        assert not bool(out["meta.jax"]) and not bool(out["meta.hpclinalg"])
        assert str(out["entry.float64.engine"]) == "dia"
