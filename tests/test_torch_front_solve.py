"""The device solver's wave solve on one buffer (``solver/device_mf.py``
``DeviceMF._solve_impl``) and its level step as one hand-written kernel a
sweep (``ops/cuda_front_solve.py``, ``csrc/front_solve.cu``).

On the CPU: the single-buffer plain step against the solve as it was
written before it (four buffers: ``four_buffer_solve`` below) for chol,
ldl and lu (lu also transposed), S = 1 and 4 (a top tree), k = 1 and 8,
f64 and c128; the plan's live counts against ``ccol`` and ``crow_live``;
the counters (every level step plain on the CPU); the shape rule at the
512² plan's levels; the wrapper's refusals; and the whole solve with a
stand-in for the kernel that computes the kernel's contract from its own
arguments (live counts, the operand views of each kind), reading no
padding. On the card (``-m card``; this file imports no JAX, so it runs
there with ``python -m pytest --noconftest -m card
tests/test_torch_front_solve.py``): the kernel against the plain step at
every level shape of the 512² plan in the four types at k = 1, 8 and 64;
a captured solve graph's replay against the eager solve; the counters at
k = 1 and 64; and a c128 block solve of 64 shots of a damped 512²
Helmholtz operator with no refinement sweep.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg_torch as ht
from hpclinalg_torch.ops import cuda_front_solve as cfs
from hpclinalg_torch.parallel import comm
from hpclinalg_torch.solver import device_mf as tdm
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.tools.matrices import (between_eigenvalues, helmholtz,
                                            laplace2d)
from hpclinalg_torch.utils import profiling

torch.set_num_threads(1)

GRID = 10                      # laplace2d(10): the CPU cases
DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
RTOL = {torch.float32: 1e-5, torch.complex64: 1e-5, torch.float64: 1e-12,
        torch.complex128: 1e-12}
# the 512² plan's local levels (device_engine at S = 1): (B, NC, NF)
PLAN512 = [(27647, 16, 30), (4101, 20, 43), (2039, 28, 64), (988, 56, 119),
           (483, 95, 190), (238, 136, 288), (109, 191, 403), (48, 287, 571),
           (27, 311, 803), (8, 404, 896), (4, 1168, 1788), (2, 1117, 1698),
           (1, 1894, 1894)]


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.tracing(False)
    profiling.reset_trace()
    yield
    profiling.tracing(False)
    profiling.reset_trace()


def rel_gap(got, want):
    got, want = got.cpu(), want.cpu()
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                  1e-300)


# ---------------------------------------------------------------------------
# the solve before the single buffer: y, contrib, zloc and xloc
# ---------------------------------------------------------------------------

def four_buffer_solve(eng, loc_factors, top_factors, bloc, tr=False):
    """``DeviceMF._solve_impl`` as it was written with four buffers: the
    updates gathered in ``contrib``, z in ``zloc``, x in ``xloc``."""
    kind = eng.kind

    def fwd(fac, seg):
        if kind == "ldl":
            w = fac[0] @ seg
            return w / fac[1][..., :, None], w
        w = (fac[1].mT if kind == "lu" and tr else fac[0]) @ seg
        return w, w

    def bwd(fac, rhs, xr):
        if kind == "lu" and not tr:
            return fac[1] @ (rhs - fac[3] @ xr)
        L21 = fac[2] if kind == "lu" else fac[-1]
        return fac[0].mT @ (rhs - L21.mT @ xr)

    def l21(fac):
        if kind != "lu":
            return fac[-1]
        return fac[3].mT if tr else fac[2]

    dt = eng.dtype
    S = eng.backend.nlocal
    SENT, TOPM, Mmax = eng.SVPAD, eng.TOPM, eng.Mmax
    k = bloc.shape[2]
    y = torch.cat([bloc.to(dt), bloc.new_zeros((S, 1, k), dtype=dt)], 1)
    contrib = torch.zeros_like(y)
    zloc = torch.zeros_like(y)
    ar = torch.arange(S)[:, None, None]
    for m, fac in zip(eng.local_levels, loc_factors):
        seg = y[ar, m.ccol] + contrib[ar, m.ccol]
        z, w = fwd(fac, seg)
        zloc[ar, m.ccol] = z
        upd = l21(fac) @ w
        contrib.view(-1, k).index_add_(0, m.crow_add, torch.where(
            m.crow_live, -upd, 0).view(-1, k))
        zloc[:, SENT] = 0
    ytop = torch.zeros((TOPM + 1, k), dtype=dt)
    if TOPM:
        ytop[:TOPM] = comm.all_reduce(
            eng.backend, (y + contrib)[:, Mmax: Mmax + TOPM].sum(dim=0))
    for m, fac in zip(eng.top_levels, top_factors):
        z, w = fwd(fac, ytop[m.ccol])
        ytop[m.ccol] = z
        upd = l21(fac) @ w
        ytop.index_add_(0, m.crow_add, torch.where(
            m.crow_live, -upd, 0).view(-1, k))
        ytop[TOPM] = 0
    for m, fac in zip(reversed(eng.top_levels), reversed(top_factors)):
        ytop[m.ccol] = bwd(fac, ytop[m.ccol], ytop[m.crow])
        ytop[TOPM] = 0
    xtop = torch.zeros_like(ytop)
    if eng.n_topcols:
        xtop[eng.topcols] = ytop[eng.topcols]
    xloc = torch.zeros_like(y)
    if TOPM:
        xloc[:, Mmax: Mmax + TOPM] = xtop[:TOPM]
    for m, fac in zip(reversed(eng.local_levels), reversed(loc_factors)):
        xloc[ar, m.ccol] = bwd(fac, zloc[ar, m.ccol], xloc[ar, m.crow])
        xloc[:, SENT] = 0
    return xloc


# ---------------------------------------------------------------------------
# CPU cases
# ---------------------------------------------------------------------------

def matrix(kind, npdt):
    """laplace2d(GRID) (chol); shifted between two eigenvalues, or the
    damped Helmholtz operator in c128 (ldl); with its strict upper triangle
    scaled by 1.5, seeded imaginary parts in c128 (lu)."""
    L = laplace2d(GRID)
    n = L.shape[0]
    if kind == "chol":
        return L
    if kind == "ldl":
        if npdt == np.complex128:
            return helmholtz(GRID)
        return (L - between_eigenvalues(GRID, 1.0) * sp.eye(n)).tocsr()
    U = (L + 0.5 * sp.triu(L, 1)).tocsr()
    if npdt == np.complex128:
        rng = np.random.default_rng(3)
        U = U.astype(np.complex128)
        U.data = U.data + 0.2j * rng.standard_normal(U.nnz)
    return U


_FACTORS = {}


def factored(kind, npdt, S):
    """The device factorization of ``matrix(kind, npdt)`` at S shards on the
    CPU, made once a module."""
    key = (kind, np.dtype(npdt).name, S)
    if key not in _FACTORS:
        be = ht.backend_auto(S, dtype=npdt, device="cpu")
        A = ht.DistSparseMatrix.from_scipy(matrix(kind, npdt), be, dtype=npdt)
        if kind == "lu":
            F = ht.lu(A, method="device")
        else:
            F = ht.ldlt(A, method="device", spd=kind == "chol")
        assert isinstance(F, tdm.DeviceFactorization)
        _FACTORS[key] = F
    return _FACTORS[key]


def rhs(F, k, seed):
    """A seeded (S, Lrow, k) right-hand side on F's rows, gathered into the
    engine's compact spaces: (b, bloc)."""
    eng = F.engine
    n = eng.n
    rng = np.random.default_rng(seed)
    bh = rng.standard_normal((n, k))
    if eng.dtype.is_complex:
        bh = bh + 1j * rng.standard_normal((n, k))
    B = ht.DistDenseMatrix.from_global(bh, F.backend)
    b = B.data.to(eng.dtype)
    return b, eng.in_plan.apply(b)


CASES = [("chol", np.float64, False)] + [
    (kind, npdt, False) for kind in ("ldl", "lu")
    for npdt in (np.float64, np.complex128)] + [
    ("lu", npdt, True) for npdt in (np.float64, np.complex128)]


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("kind,npdt,tr", CASES,
                         ids=[f"{c[0]}-{np.dtype(c[1]).name}"
                              + ("-T" if c[2] else "") for c in CASES])
def test_single_buffer_equals_the_four_buffer_solve(kind, npdt, tr, S, k):
    """The plain single-buffer solve and the four-buffer solve on the same
    inverted factors and right-hand side, moved out to the rows: within
    1e-12 of the largest entry (the updates are summed into b in another
    order; the single buffer keeps the in-plan's filler in the slots past
    a shard's columns, which no table and no out-plan reads); the solution
    solves the system."""
    F = factored(kind, npdt, S)
    eng = F.engine
    if S == 4:
        assert eng.top_levels, "S = 4 has a top tree"
    b, bloc = rhs(F, k, 7 + k)
    loc, top = F._prepped
    x = eng.out_plan.apply(eng._solve_impl(loc, top, bloc.clone(), tr))
    want = eng.out_plan.apply(four_buffer_solve(eng, loc, top, bloc.clone(),
                                                tr))
    assert rel_gap(x, want) <= 1e-12
    M = matrix(kind, npdt)
    M = M.T if tr else M
    xh = np.concatenate([x[s, : int(F.A.row_partition[s + 1]
                                        - F.A.row_partition[s])].numpy()
                         for s in range(S)])
    bh = np.concatenate([b[s, : int(F.A.row_partition[s + 1]
                                    - F.A.row_partition[s])].numpy()
                         for s in range(S)])
    assert np.linalg.norm(M @ xh - bh) <= 1e-8 * np.linalg.norm(bh)


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("kind", ["chol", "ldl", "lu"])
def test_live_counts_agree_with_the_tables(kind, S):
    """Every level's ``ncol`` and ``nrow`` (int32) count the entries of
    ``ccol`` and ``crow`` that are not the sentinel, and those come
    first."""
    eng = factored(kind, np.float64, S).engine
    for top, levels in ((False, eng.local_levels), (True, eng.top_levels)):
        sent = eng.TOPM if top else eng.SVPAD
        for m in levels:
            cc, cr = m.ccol.numpy(), m.crow.numpy()
            live = m.crow_live.numpy()[..., 0]
            ncol, nrow = m.ncol.numpy(), m.nrow.numpy()
            assert m.ncol.dtype == m.nrow.dtype == torch.int32
            assert ncol.shape == cc.shape[:-1] == nrow.shape
            np.testing.assert_array_equal(ncol, (cc != sent).sum(-1))
            np.testing.assert_array_equal(nrow, live.sum(-1))
            np.testing.assert_array_equal(live, cr != sent)
            np.testing.assert_array_equal(
                cc != sent, np.arange(m.NC) < ncol[..., None])
            np.testing.assert_array_equal(
                live, np.arange(m.NF - m.NC) < nrow[..., None])
            assert (ncol <= m.NC).all() and (nrow <= m.NF - m.NC).all()


@pytest.mark.parametrize("S", [1, 4])
def test_cpu_counts_every_level_step_plain(S):
    """On the CPU every level step of both sweeps, local and top, is the
    plain step: ``solver.front_steps_plain`` counts them, the kernel's
    counter and launches stay 0."""
    F = factored("ldl", np.complex128, S)
    eng = F.engine
    _, bloc = rhs(F, 2, 1)
    launches = (cfs.front_fwd.launches, cfs.front_bwd.launches)
    profiling.tracing(True)
    eng._solve_impl(*F._prepped, bloc)
    counters = profiling.trace_report()["counters"]
    steps = 2 * (len(eng.local_levels) + len(eng.top_levels))
    assert counters == {"solver.front_steps_plain": steps}
    assert (cfs.front_fwd.launches, cfs.front_bwd.launches) == launches


def test_shape_rule_at_the_512_plan():
    """At k = 1 and 8 every level of the 512² plan takes the kernel in the
    four types; at k = 64 in c128 the small fronts (levels 0-6, NF up to
    403) do and the wide ones keep the library's products; the CPU and the
    other types never do."""
    for k in (1, 8):
        for dt in DTYPES:
            assert all(cfs.front_route("cuda", dt, NC, NF, k)
                       for _B, NC, NF in PLAN512)
    got = [cfs.front_route("cuda", torch.complex128, NC, NF, 64)
           for _B, NC, NF in PLAN512]
    assert got == [True] * 7 + [False] * 6
    for B, NC, NF in PLAN512:
        assert not cfs.front_route("cpu", torch.float64, NC, NF, 1)
        assert not cfs.front_route("cuda", torch.float16, NC, NF, 1)
    assert cfs.intensity(16, 30, 1, torch.float64) < 0.25


def test_column_tile_and_launch_mode():
    """The columns a block (1, 8, 32) and the launch's layout: a warp a
    front at k = 1 up to ``TILE`` columns, the two-phase mode past
    ``SERIAL_TILES`` row tiles or where a level would leave the card idle,
    else a block a front and column tile."""
    assert [cfs.column_tile(k) for k in (1, 2, 8, 9, 64)] == [1, 8, 8, 32, 32]
    modes = [cfs.launch_mode(B, NC, 1, 132) for B, NC, _NF in PLAN512]
    assert modes == [2, 2, 2, 0, 0] + [1] * 8
    modes = [cfs.launch_mode(B, NC, 64, 132) for B, NC, _NF in PLAN512]
    assert modes == [0] * 5 + [1] * 8
    assert cfs.launch_mode(1, 32, 8, 132) == 0
    assert cfs.launch_mode(1, 33, 8, 132) == 1


def level_operands(m, y, kind="fwd", d=True):
    """The tables and a seeded front-shaped operand set of level m for y's
    type on y's device, as a factor has them: A triangular, identity on
    its dead diagonal, zero elsewhere off the live block; M zero off its
    live rows and columns; d 1 where dead. A column-major, as torch's
    triangular solves return their inverses; the backward operands the
    transposed views."""
    dt, dev = y.dtype, y.device
    ccol, crow, ncol, nrow = (t.to(dev) for t in (m.ccol, m.crow, m.ncol,
                                                   m.nrow))
    S, B, NC = ccol.shape
    NR = crow.shape[-1]
    g = torch.Generator(device=dev).manual_seed(NC * 7 + NR)
    lc = torch.arange(NC, device=dev) < ncol[..., None]
    lr = torch.arange(NR, device=dev) < nrow[..., None]
    A = torch.randn((S, B, NC, NC), generator=g, dtype=dt, device=dev) \
        / NC ** 0.5
    A = torch.where(lc[..., :, None] & lc[..., None, :], torch.tril(A), 0)
    A = A + torch.diag_embed((~lc).to(dt))
    A = A.mT.contiguous().mT
    M = torch.randn((S, B, NR, NC), generator=g, dtype=dt, device=dev) \
        / NC ** 0.5
    M = torch.where(lr[..., :, None] & lc[..., None, :], M, 0)
    dd = torch.where(lc, 3 + torch.rand((S, B, NC), generator=g, device=dev)
                     .to(dt), 1) if d else None
    return ccol, crow, ncol, nrow, A, M, dd


def standin_fwd(y, ccol, crow, ncol, nrow, A, M, d=None):
    """The kernel's contract computed from its own arguments on any device:
    only live rows of y and live entries of A's lower triangle and of M
    are read, only live rows written."""
    cfs.operands("front_fwd", y, ccol, crow, ncol, nrow, A, M, d, False)
    S, B, NC = ccol.shape
    NR = crow.shape[-1]
    dev = y.device
    lc = torch.arange(NC, device=dev) < ncol[..., None]
    lr = torch.arange(NR, device=dev) < nrow[..., None]
    ar = torch.arange(S, device=dev)[:, None, None]
    seg = torch.where(lc[..., None], y[ar, ccol], 0)
    w = torch.where(lc[..., :, None] & lc[..., None, :], A.tril(), 0) @ seg
    z = w if d is None else w / torch.where(lc, d, 1)[..., None]
    s, b, i = lc.nonzero(as_tuple=True)
    y[s, ccol[s, b, i]] = z[s, b, i]
    u = torch.where(lr[..., :, None] & lc[..., None, :], M, 0) @ w
    s, b, r = lr.nonzero(as_tuple=True)
    y.index_put_((s, crow[s, b, r]), -u[s, b, r], accumulate=True)
    return y


def standin_bwd(y, ccol, crow, ncol, nrow, A, M):
    """The backward contract, as ``standin_fwd``."""
    cfs.operands("front_bwd", y, ccol, crow, ncol, nrow, A, M, None, True)
    S, B, NC = ccol.shape
    NR = crow.shape[-1]
    dev = y.device
    lc = torch.arange(NC, device=dev) < ncol[..., None]
    lr = torch.arange(NR, device=dev) < nrow[..., None]
    ar = torch.arange(S, device=dev)[:, None, None]
    z = torch.where(lc[..., None], y[ar, ccol], 0)
    xr = torch.where(lr[..., None], y[ar, crow], 0)
    Ml = torch.where(lc[..., :, None] & lr[..., None, :], M, 0)
    Au = torch.where(lc[..., :, None] & lc[..., None, :], A.triu(), 0)
    x = Au @ (z - Ml @ xr)
    s, b, i = lc.nonzero(as_tuple=True)
    y[s, ccol[s, b, i]] = x[s, b, i]
    return y


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("kind,npdt,tr", CASES,
                         ids=[f"{c[0]}-{np.dtype(c[1]).name}"
                              + ("-T" if c[2] else "") for c in CASES])
def test_solve_with_a_standin_kernel(kind, npdt, tr, S):
    """The solve with every level routed to the kernel (the route patched
    on, the kernel a stand-in for its contract): the plain solve's result
    within 1e-12, one ``solver.front_steps_kernel`` a level step and no
    plain step."""
    F = factored(kind, npdt, S)
    eng = F.engine
    _, bloc = rhs(F, 3, 11)
    want = eng.out_plan.apply(eng._solve_impl(*F._prepped, bloc.clone(),
                                              tr))
    profiling.tracing(True)
    with dc.patched(cfs, front_route=lambda *a: True, front_fwd=standin_fwd,
                    front_bwd=standin_bwd):
        got = eng.out_plan.apply(eng._solve_impl(*F._prepped, bloc.clone(),
                                                 tr))
    counters = profiling.trace_report()["counters"]
    steps = 2 * (len(eng.local_levels) + len(eng.top_levels))
    assert counters == {"solver.front_steps_kernel": steps}
    assert rel_gap(got, want) <= 1e-12


@pytest.mark.parametrize("bwd", [False, True])
def test_standin_reads_no_padding(bwd):
    """The contract's stand-in at a level of the 512² plan's shape with NaN
    in every dead entry of the operands and y's sentinel untouched: the
    plain step's result, which the padding's identity and zeros give."""
    be = ht.backend_auto(1, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(laplace2d(24), be)
    eng = tdm.device_engine(A, "ldl", np.float64)
    m = eng.local_levels[0]
    y = torch.randn((1, eng.SVPAD + 1, 3), dtype=torch.float64)
    y[:, -1] = 0
    ccol, crow, ncol, nrow, Af, M, d = level_operands(m, y)
    lc = torch.arange(m.NC) < ncol[..., None]
    lr = torch.arange(m.NF - m.NC) < nrow[..., None]
    want = y.clone()
    if bwd:
        tdm._bwd_plain(want, ccol, crow, Af.mT, M.mT)
    else:
        tdm._fwd_plain(want, ccol, m.crow_add, m.crow_live, Af, M, d)
    nan = float("nan")
    live2 = lc[..., :, None] & lc[..., None, :]
    tri = torch.ones(Af.shape[-2:], dtype=torch.bool).tril()
    An = torch.where(live2 & tri, Af, nan)
    Mn = torch.where(lr[..., :, None] & lc[..., None, :], M, nan)
    dn = torch.where(lc, d, nan)
    got = y.clone()
    if bwd:
        standin_bwd(got, ccol, crow, ncol, nrow, An.mT, Mn.mT)
    else:
        standin_fwd(got, ccol, crow, ncol, nrow, An, Mn, dn)
    assert not got.isnan().any()
    assert rel_gap(got, want) <= 1e-12


def test_wrapper_refuses_cpu_tensors_and_other_types():
    be = ht.backend_auto(1, device="cpu")
    A = ht.DistSparseMatrix.from_scipy(laplace2d(12), be)
    eng = tdm.device_engine(A, "ldl", np.float64)
    m = eng.local_levels[0]
    y = torch.zeros((1, eng.SVPAD + 1, 2), dtype=torch.float64)
    ops = level_operands(m, y)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cfs.front_fwd(y, *ops)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cfs.front_bwd(y, *ops[:4], ops[4].mT, ops[5].mT)
    with pytest.raises(TypeError, match="float32, float64"):
        cfs.front_fwd(y.to(torch.float16), *ops)
    with pytest.raises(ValueError, match="M of"):
        cfs.front_bwd(y, *ops[:6])
    with pytest.raises(ValueError, match="ncol of"):
        cfs.front_fwd(y, ops[0], ops[1], ops[2].long(), *ops[3:])


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def plan512(card):
    """The device plan of laplace2d(512) at S = 1 (its tables alone)."""
    be = ht.backend_auto(1, dtype=np.float64, device=card)
    A = ht.DistSparseMatrix.from_scipy(laplace2d(512), be)
    eng = tdm.device_engine(A, "ldl", np.float64)
    yield eng
    ht.clear_plan_cache("device_mf")


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 8, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_the_plain_step_at_each_level(card, plan512, dtype,
                                                     k):
    """Each level of the 512² plan, a seeded y and front-shaped operands:
    the forward step with and without pivots and the backward step (the
    transposed views), the kernel against the plain step on the card,
    within RTOL of the largest entry."""
    eng = plan512
    assert [(m.B, m.NC, m.NF) for m in eng.local_levels] == PLAN512
    g = torch.Generator(device=card).manual_seed(k)
    for m in eng.local_levels:
        y = torch.randn((1, eng.SVPAD + 1, k), generator=g, dtype=dtype,
                        device=card)
        y[:, -1] = 0
        for d in (True, False):
            ccol, crow, ncol, nrow, A, M, dd = level_operands(m, y, d=d)
            crow_add, crow_live = m.crow_add.to(card), m.crow_live.to(card)
            want, got = y.clone(), y.clone()
            tdm._fwd_plain(want, ccol, crow_add, crow_live, A, M, dd)
            cfs.front_fwd(got, ccol, crow, ncol, nrow, A, M, dd)
            torch.cuda.synchronize()
            assert rel_gap(got, want) <= RTOL[dtype], (m.NC, m.NF, "fwd", d)
        want, got = y.clone(), y.clone()
        tdm._bwd_plain(want, ccol, crow, A.mT, M.mT)
        cfs.front_bwd(got, ccol, crow, ncol, nrow, A.mT, M.mT)
        torch.cuda.synchronize()
        assert rel_gap(got, want) <= RTOL[dtype], (m.NC, m.NF, "bwd")


def damped_helmholtz(k, seed):
    """A 5-point operator on a k² grid with diagonal 4 − s μ (1 − 0.1 i),
    s = (2π/10)², μ seeded in [0.8, 1.2]: the benchmark's damped
    complex-symmetric Helmholtz form at 10 points a wavelength."""
    L = laplace2d(k).astype(np.complex128)
    mu = np.random.default_rng(seed).uniform(0.8, 1.2, k * k)
    s = (2 * np.pi / 10) ** 2
    return (L - sp.diags(s * mu * (1 - 0.1j))).tocsr()


@pytest.fixture(scope="module")
def helm512(card):
    """ldlt(method="device") of the damped 512² Helmholtz operator in c128,
    and 64 point sources along the second grid row (columns 4 + 8c)."""
    H = damped_helmholtz(512, 5)
    be = ht.backend_auto(1, dtype=np.complex128, device=card)
    A = ht.DistSparseMatrix.from_scipy(H, be)
    F = ht.ldlt(A, method="device", spd=False)
    assert isinstance(F, tdm.DeviceFactorization) and F.refusal is None
    Bh = np.zeros((H.shape[0], 64), np.complex128)
    Bh[512 + 4 + 8 * np.arange(64), np.arange(64)] = 1
    yield H, F, Bh
    F.finalize()
    ht.clear_plan_cache("device_mf")


def traced(fn):
    """fn() with the recorder on from a reset: (result, counters)."""
    profiling.reset_trace()
    profiling.tracing(True)
    out = fn()
    torch.cuda.synchronize()
    profiling.tracing(False)
    return out, profiling.trace_report()["counters"]


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 64])
def test_counters_follow_the_shape_rule(card, helm512, k):
    """A replayed solve graph of width k: every level step takes the kernel
    at k = 1; at k = 64 the levels of ``front_route``, the others the plain
    step; the launches agree with the counter."""
    H, F, Bh = helm512
    eng = F.engine
    b = ht.DistDenseMatrix.from_global(Bh[:, :k], F.backend)
    F.solve_matrix(b, refine=0)             # captures the graph of width k
    dc.reset_launch_counts()
    _, counters = traced(lambda: F.solve_matrix(b, refine=0))
    levels = eng.local_levels + eng.top_levels
    taken = sum(cfs.front_route(card, torch.complex128, m.NC, m.NF, k)
                for m in levels)
    if k == 1:
        assert taken == len(levels)
    else:
        assert taken == 7 and len(levels) == 13
    assert counters.get("solver.front_steps_kernel") == 2 * taken
    assert counters.get("solver.front_steps_plain", 0) == \
        2 * (len(levels) - taken)
    n = dc.launch_counts()
    assert n["front_fwd"] == n["front_bwd"] == taken


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 8, 64])
def test_replay_equals_the_eager_solve(card, helm512, k):
    """The captured solve graph of width k replayed against the eager
    ``solve_prepped`` on the same factors: within 1e-12 (the update adds
    are atomic, their order free)."""
    H, F, Bh = helm512
    b = ht.DistDenseMatrix.from_global(Bh[:, :k], F.backend)
    b3 = b.data.to(F.engine.dtype)
    F._solve_dist(b3, False)                 # the capture
    got = F._solve_dist(b3, False)
    want = F.engine.solve_prepped(F._prepped, b3)
    torch.cuda.synchronize()
    assert (k, False) in F._solve_graphs
    assert rel_gap(got, want) <= 1e-12


@pytest.mark.card
def test_block_solve_needs_no_refinement(card, helm512):
    """``solve_matrix`` of the 64 shots with the default refinement: the
    worst column's residual at most 1e-12 and no refinement sweep."""
    H, F, Bh = helm512
    X, counters = traced(lambda: F.solve_matrix(Bh))
    res = np.linalg.norm(H @ X - Bh, axis=0) / np.linalg.norm(Bh, axis=0)
    assert res.max() <= 1e-12, res.max()
    assert "solver.refine_sweeps" not in counters
    assert counters.get("solver.front_steps_kernel", 0) > 0
