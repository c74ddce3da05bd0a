"""The CG step's fused vector work (``hpclinalg_torch/ops/cuda_cg.py``,
``csrc/cg_vec.cu``) and the choice between it and the plain step
(``entry.cg_step_fn``).

On the CPU: the plain step is taken on the CPU and for complex types, and
counted; the route, the grid and the launchers' refusals. On the card
(``-m card``; this file imports no JAX, so it runs there with
``python -m pytest --noconftest -m card tests/test_torch_cg_fused.py``):
the fused step against the plain step (its oracle, ``cuda_cg.fused_route``
patched off) on the DIA, resident and ELL engines at S = 1 and 4, f64 to
1e-12 and f32 to 1e-5 of the largest entry (the dots are summed in another
order and, in f32, in double); the kernels against the plain arithmetic;
replays bit for bit against eager
fused steps; ``out`` aliased to the inputs; the padding rows; the counter.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg_torch as ht
from hpclinalg_torch import entry as te
from hpclinalg_torch.ops import cuda_cg
from hpclinalg_torch.ops import spmv as tspmv
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.tools.matrices import laplace2d
from hpclinalg_torch.utils import profiling

torch.set_num_threads(1)

RTOL = {np.float64: 1e-12, np.float32: 1e-5}
STEPS = 20
K = 24                      # laplace2d(K), permuted off the DIA engine
BIG = 301                   # laplace2d(BIG): many blocks, a ragged tail
# each engine and the ops/spmv.py limits its plan is built under
ENGINES = {"dia": {}, "ell": {"DENSE_MAX_ELEMS": 0},
           "resident": {"DENSE_MAX_ELEMS": 0, "MIN_NNZ": 0,
                        "MAX_ELL_BLOWUP": 16.0}}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def close(got, want, rtol):
    got, want = got.double().cpu(), want.double().cpu()
    err = float((got - want).abs().max())
    assert err <= rtol * float(want.abs().max()), (err, rtol)


def matrix(engine, k=K):
    """laplace2d(k), symmetrically permuted off the DIA engine."""
    M = laplace2d(k)
    if engine == "dia":
        return M
    q = np.random.default_rng(3).permutation(k * k)
    return sp.csr_matrix(M[q][:, q])


def cg_case(engine, S, dtype, device, fused=True, k=K):
    """(cg_step, args, b): the step on ``matrix(engine, k)`` built under
    the engine's limits, plain when ``fused`` is False (the route patched
    off while it is built), and its arguments (0, b, b), b seeded."""
    be = ht.backend_auto(S, dtype=dtype, device=device)
    M = matrix(engine, k)
    route = cuda_cg.fused_route
    ht.clear_plan_cache("vector_plan")
    try:
        with dc.patched(tspmv, **ENGINES[engine]), \
                dc.patched(cuda_cg, fused_route=route if fused
                           else lambda device, dtype: False):
            A = ht.DistSparseMatrix.from_scipy(M, be, dtype=dtype)
            step, x0 = te.cg_step_fn(A, be)
    finally:
        ht.clear_plan_cache("vector_plan")
    assert step.engine == engine and step.fused == fused
    bh = np.random.default_rng(5).standard_normal(M.shape[0])
    b = ht.DistVector.from_global(bh, be, dtype=dtype)
    return step, (x0.data, b.data, b.data), b


def run(step, args, steps=STEPS):
    for _ in range(steps):
        args = step(*args)
    return args


# ---- the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.complex128],
                         ids=["f64", "c128"])
def test_cpu_step_takes_the_plain_path(dtype):
    """On the CPU, in a real or a complex type, the step runs its plain
    arithmetic and counts ``cg.plain_steps`` once a step."""
    be = ht.backend_auto(2, dtype=dtype, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(laplace2d(8), be, dtype=dtype)
    step, x0 = te.cg_step_fn(A, be)
    assert not step.fused
    b = ht.DistVector.from_global(np.ones(64), be, dtype=dtype)
    profiling.reset_trace()
    ht.tracing(True)
    try:
        run(step, (x0.data, b.data, b.data), 3)
        rep = ht.trace_report()
    finally:
        ht.tracing(False)
        profiling.reset_trace()
    assert rep["counters"] == {"cg.plain_steps": 3}


@pytest.mark.parametrize("device, dtype, fused", [
    ("cuda", torch.float64, True), ("cuda", torch.float32, True),
    ("cuda", torch.complex128, False), ("cuda", torch.complex64, False),
    ("cuda", torch.float16, False), ("cpu", torch.float64, False)])
def test_fused_route_is_a_cuda_device_and_a_real_type(device, dtype, fused):
    assert cuda_cg.fused_route(device, dtype) is fused


@pytest.mark.parametrize("n, sms, grid", [
    (0, 132, 1), (1, 132, 1), (256, 132, 1), (257, 132, 2),
    (90601, 132, 354), (1124864, 132, 1056), (1124864, 4, 32)])
def test_grid_blocks(n, sms, grid):
    """A thread an entry, at most BLOCKS_PER_SM blocks an SM, one at
    least: the grid, and so the order of the sums, follow from the
    vector's length and the device alone."""
    assert cuda_cg.grid_blocks(n, sms) == grid


LAUNCHERS = {
    "cg_dots": lambda v: cuda_cg.cg_dots(v, v.clone(), v.clone(), None),
    "cg_update_xr": lambda v: cuda_cg.cg_update_xr(
        v, v.clone(), v.clone(), v.clone(), None),
    "cg_update_p": lambda v: cuda_cg.cg_update_p(v, v.clone(), None),
}
FAULTS = {
    "cpu": (ValueError, "CUDA tensors",
            lambda: torch.ones(2, 8, dtype=torch.float64)),
    "strided": (ValueError, "contiguous",
                lambda: torch.ones(8, 2, dtype=torch.float64).T),
    "complex": (TypeError, "float32 or float64",
                lambda: torch.ones(2, 8, dtype=torch.complex128)),
    "misaligned": (ValueError, "16-byte aligned",
                   lambda: torch.ones(18, dtype=torch.float64)[1:17]),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("launcher", list(LAUNCHERS))
def test_launcher_refuses(launcher, fault):
    """A CPU, a non-contiguous, a complex or a misaligned vector raises,
    naming what the kernels take, before anything is launched."""
    err, words, make = FAULTS[fault]
    with pytest.raises(err, match=words):
        LAUNCHERS[launcher](make())


def test_workspace_refuses_the_cpu():
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_cg.Workspace(64, torch.float64, "cpu")


def test_fused_route_refuses_vectors_of_another_type():
    """Where the step takes the kernels (the route patched on here), a
    backend whose vectors are not of A @ x's type raises at build instead
    of running the plain step."""
    be = ht.backend_auto(1, dtype=np.float32, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(laplace2d(8), be, dtype=np.float64)
    with dc.patched(cuda_cg, fused_route=lambda device, dtype: True), \
            pytest.raises(ValueError, match="build A on a torch.float64"):
        te.cg_step_fn(A, be)


# ---- the card --------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_fused_step_equals_the_plain_step(card, engine, S, dtype):
    fused = run(*cg_case(engine, S, dtype, card)[:2])
    plain = run(*cg_case(engine, S, dtype, card, fused=False)[:2])
    for f, p in zip(fused, plain):
        assert f.dtype == p.dtype and f.shape == p.shape
        close(f, p, RTOL[dtype])


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernels_against_the_plain_arithmetic(card, dtype):
    """Each kernel on 90,601 entries (a ragged last unit): the dots to
    1e-12 (f64) or 1e-6 (f32) of torch's, the updates bit for bit
    ``x + alpha * p`` with alpha and beta divided as the plain step does."""
    n = BIG * BIG
    g = torch.Generator(device=card).manual_seed(11)

    def vec():
        return torch.randn(n, generator=g, dtype=torch.float64,
                           device=card).to(dtype)

    x, r, p, Ap = vec(), vec(), vec(), vec()
    ws = cuda_cg.Workspace(n, dtype, card)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    d = cuda_cg.cg_dots(p, Ap, r, ws).clone()
    want = torch.stack([torch.dot(p.double(), Ap.double()),
                        torch.dot(r.double(), r.double())])
    close(d, want, tol)
    alpha = d[1] / d[0]
    xo, ro = cuda_cg.cg_update_xr(x, r, p, Ap, ws)
    assert torch.equal(xo, x + alpha * p) and torch.equal(ro, r - alpha * Ap)
    rr = ws.rr.clone()
    close(rr, torch.dot(ro.double(), ro.double()).reshape(1), tol)
    po = cuda_cg.cg_update_p(ro, p, ws)
    assert torch.equal(po, ro + (rr[0] / d[1]) * p)
    assert int(ws.ticket.item()) == 0


@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_replays_equal_eager_fused_steps(card, dtype):
    """20 replays of the captured step equal 20 eager fused steps bit for
    bit on laplace2d(301) (354 blocks a launch), and each replay counts
    one launch of each kernel."""
    step, args, _ = cg_case("dia", 1, dtype, card, k=BIG)
    eager = run(step, args)
    graph = te.capture(step, args)
    before = [f.launches for f in (cuda_cg.cg_dots, cuda_cg.cg_update_xr,
                                   cuda_cg.cg_update_p)]
    rep = run(graph, args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, rep))
    assert [f.launches - n for f, n in zip(
        (cuda_cg.cg_dots, cuda_cg.cg_update_xr, cuda_cg.cg_update_p),
        before)] == [STEPS] * 3


@pytest.mark.card
@pytest.mark.parametrize("engine", list(ENGINES))
def test_out_aliased_to_the_inputs_equals_fresh_outputs(card, engine):
    step, new, _ = cg_case(engine, 4, np.float64, card)
    own = tuple(t.clone() for t in new)
    for _ in range(5):
        new = step(*new)
        assert all(a is c for a, c in zip(step(*own, out=own), own))
        assert all(torch.equal(a, c) for a, c in zip(new, own))


@pytest.mark.card
def test_padding_rows_stay_zero(card):
    """laplace2d(15) on 4 shards: 225 rows in 4 * 57 slots."""
    step, args, b = cg_case("dia", 4, np.float64, card, k=15)
    assert b.L * 4 > b.n
    mask = b.mask()
    for o in run(step, args):
        assert not bool(o[~mask].any())


@pytest.mark.card
def test_fused_steps_count_one_a_replay(card):
    step, args, _ = cg_case("dia", 1, np.float64, card)
    profiling.reset_trace()
    ht.tracing(True)
    try:
        graph = te.capture(step, args)
        profiling.reset_trace()
        run(graph, args)
        torch.cuda.synchronize()
        rep = ht.trace_report()
    finally:
        ht.tracing(False)
        profiling.reset_trace()
    assert rep["counters"]["cg.fused_steps"] == STEPS
    assert "cg.plain_steps" not in rep["counters"]
