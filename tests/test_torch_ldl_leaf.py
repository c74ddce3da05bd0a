"""The device LDLᵀ's leaf kernel (``hpclinalg_torch/ops/cuda_ldl.py``,
``csrc/ldl_leaf.cu``) and the recursion around it
(``solver/device_mf.batched_ldl``).

On the CPU: the route (the CPU and the other types factor each leaf by
the plain recursion and count ``solver.ldl_leaf_plain``), the wrapper's
refusals, and the recursion (``_ldl_blocked``: splits above
``cuda_ldl.LEAF`` columns written into one L and d) with a stand-in for the
kernel that runs the plain recursion, against the plain recursion. On the card (``-m card``; this file
imports no JAX, so it runs there with ``python -m pytest --noconftest -m
card tests/test_torch_ldl_leaf.py``): the kernel against the plain
recursion on the CPU for 1 to ``LEAF`` columns in the four types, stacked
batches, strided views of a front buffer, junk above the diagonal and
clamped pivots; ``batched_ldl`` above the leaf size; a captured graph
replayed with a new eps bit for bit against the eager kernel; and whole
device factorizations, f64 on laplace2d(64) and c128 on helmholtz(64),
against the same factorization on the CPU (which
``tests/test_torch_device_solver.py`` and ``test_torch_complex.py`` hold
against the JAX package) and scipy. At the benchmark's size: the c128
factorization of helmholtz(256) takes the kernel at every leaf, the
kernel at each of its leaf shapes in the four types against the plain
recursion on the card, and captured graphs of the kernel and the plain
recursion at 27,647 blocks of 16 columns and 64 of 32, replayed.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import hpclinalg_torch as ht
from hpclinalg_torch.ops import cuda_ldl
from hpclinalg_torch.solver import device_mf as tdm
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.tools.matrices import helmholtz, laplace2d
from hpclinalg_torch.utils import graphs, profiling

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.float64, torch.complex64, torch.complex128]
RTOL = {torch.float32: 1e-5, torch.complex64: 1e-5, torch.float64: 1e-12,
        torch.complex128: 1e-12}
EPS = 1e-6
LEAF = cuda_ldl.LEAF


@pytest.fixture(autouse=True)
def recorder_off():
    profiling.tracing(False)
    profiling.reset_trace()
    yield
    profiling.tracing(False)
    profiling.reset_trace()


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def symmetric(shape, dtype, seed, tiny=True):
    """A seeded batch (..., n, n), symmetric with the plain transpose,
    diagonally dominant with alternating signs (indefinite, no growth).
    With ``tiny``, pivots under ``EPS`` whose rows and columns are zero:
    entry 0 in every block (1e-9, the sign alternating over the batch) and,
    where n > 3, a zero row and column 3 in the first block."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal(shape)
    if dtype.is_complex:
        M = M + 1j * rng.standard_normal(shape)
    n = shape[-1]
    M = M + np.swapaxes(M, -1, -2)
    M = M + 3 * n * np.diag(np.where(np.arange(n) % 2, -1.0, 1.0))
    if tiny:
        M[..., 0, :] = 0
        M[..., :, 0] = 0
        sign = np.where(np.arange(int(np.prod(shape[:-2]))) % 2, -1.0, 1.0)
        M[..., 0, 0] = 1e-9 * sign.reshape(shape[:-2])
        if n > 3:
            first = (0,) * (len(shape) - 2)
            M[first + (3, slice(None))] = 0
            M[first + (slice(None), 3)] = 0
    return torch.from_numpy(M).to(dtype)


def close(got, want, rtol):
    got, want = got.cpu(), want.cpu()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    assert err <= rtol * max(float(want.abs().max()), 1.0), (err, rtol)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def test_route():
    """The kernel takes CUDA tensors of the four types; nothing else."""
    for dt in DTYPES:
        assert cuda_ldl.leaf_route("cuda", dt)
        assert cuda_ldl.leaf_route(torch.device("cuda", 0), dt)
        assert not cuda_ldl.leaf_route("cpu", dt)
    for dt in (torch.float16, torch.bfloat16, torch.int64):
        assert not cuda_ldl.leaf_route("cuda", dt)


def test_wrapper_refuses_cpu_tensors_and_other_types():
    F = symmetric((3, 8, 8), torch.float64, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_ldl.ldl_leaf(F, EPS)
    with pytest.raises(TypeError, match="float32, float64"):
        cuda_ldl.ldl_leaf(F.to(torch.float16), EPS)
    with pytest.raises(TypeError, match="float32, float64"):
        cuda_ldl.ldl_leaf(F.to(torch.int64), EPS)
    with pytest.raises(ValueError, match=f"1 to {LEAF} columns"):
        cuda_ldl.ldl_leaf(symmetric((2, LEAF + 1, LEAF + 1),
                                    torch.float64, 2), EPS)
    with pytest.raises(ValueError, match=f"1 to {LEAF} columns"):
        cuda_ldl.ldl_leaf(torch.zeros(2, 4, 5, dtype=torch.float64), EPS)


def test_eps_tensor():
    """A float becomes a 0-d tensor of the real type; a 0-d tensor of it
    is taken as it is (a graph reads it at every replay)."""
    e = cuda_ldl.eps_tensor(1e-7, torch.complex128, "cpu")
    assert e.shape == () and e.dtype == torch.float64 and float(e) == 1e-7
    assert cuda_ldl.eps_tensor(e, torch.complex128, "cpu") is e
    f = cuda_ldl.eps_tensor(e, torch.complex64, "cpu")
    assert f.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128,
                                   torch.float32])
def test_cpu_takes_the_plain_route_and_counts_it(dtype):
    """On the CPU a block of at most ``LEAF`` columns is one base case,
    factored by the plain recursion: counted once as
    ``solver.ldl_leaf_plain``, never as the kernel."""
    F = symmetric((2, 3, 7, 7), dtype, 3)
    profiling.tracing(True)
    L, d, p = tdm.batched_ldl(F, EPS)
    counters = profiling.trace_report()["counters"]
    assert counters == {"solver.ldl_leaf_plain": 1}
    assert cuda_ldl.ldl_leaf.launches == 0
    want = tdm._ldl_plain(F, EPS)
    for a, b in zip((L, d, p), want):
        assert torch.equal(a, b)
    assert int(p) == 6 + 1


@pytest.mark.parametrize("n,leaves", [(33, 2), (65, 3), (100, 4)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_cpu_splits_above_the_leaf_and_counts_each_leaf(dtype, n, leaves):
    """On the CPU the split above ``LEAF`` columns is the card's, its
    leaves the plain recursion (one ``solver.ldl_leaf_plain`` each): the
    same factors and count as the plain recursion on the whole block,
    with exact zeros above L's diagonal and ones on it."""
    F = symmetric((2, 3, n, n), dtype, 6)
    F = torch.tril(F) + torch.triu(torch.full_like(F, 7.0), 1)  # junk above
    Fs = torch.tril(F) + torch.tril(F, -1).mT
    profiling.tracing(True)
    L, d, p = tdm.batched_ldl(F, EPS)
    assert profiling.trace_report()["counters"] == {
        "solver.ldl_leaf_plain": leaves}
    Lw, dw, pw = tdm._ldl_plain(Fs, EPS)
    close(L, Lw, 1e-13)
    close(d, dw, 1e-13)
    assert int(p) == int(pw) == 6 + 1
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.diagonal(L, dim1=-2, dim2=-1),
                       torch.ones_like(d))


def standin_leaf(F, eps, L, d, count):
    """The kernel's contract on the CPU: the plain recursion written into
    the views L and d, its clamped pivots added to ``count``."""
    l, dd, p = tdm._ldl_plain(F, eps)
    L.copy_(l)
    d.copy_(dd)
    count.add_(p)
    return L, d, count


@pytest.mark.parametrize("n,leaves", [(5, 1), (32, 1), (33, 2), (65, 3),
                                      (100, 4)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_blocked_recursion_with_a_standin_leaf(n, leaves, dtype):
    """The card's recursion (the route patched on, the kernel a stand-in)
    against the plain recursion: the same splits, L written into one
    buffer with exact zeros above the diagonal and ones on it, d, the
    count, and one ``solver.ldl_leaf_kernels`` a leaf."""
    F = symmetric((2, 3, n, n), dtype, 4)
    F = torch.tril(F) + torch.triu(torch.full_like(F, 7.0), 1)  # junk above
    Fs = torch.tril(F) + torch.tril(F, -1).mT
    profiling.tracing(True)
    with dc.patched(cuda_ldl, leaf_route=lambda device, dtype: True,
                    ldl_leaf=standin_leaf):
        L, d, p = tdm.batched_ldl(F, EPS)
    counters = profiling.trace_report()["counters"]
    assert counters.get("solver.ldl_leaf_kernels") == leaves
    Lw, dw, pw = tdm._ldl_plain(Fs, EPS)
    close(L, Lw, 1e-13)
    close(d, dw, 1e-13)
    assert int(p) == int(pw) == 6 + (n > 3)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    assert torch.equal(torch.diagonal(L, dim1=-2, dim2=-1),
                       torch.ones_like(d))


def test_front_kernel_ldl_uses_the_split_step():
    """``_front_kernel``'s LDLᵀ branch is ``batched_ldl`` on F11, then the
    split step on F21 and F22: the same factors as the plain recursion on
    the whole front's first NC columns."""
    F = symmetric((2, 12, 12), torch.float64, 5, tiny=False)
    (L11, d, L21), U, p, f = tdm._front_kernel("ldl", F, 7, EPS)
    Lw, dw, _ = tdm._ldl_plain(F, EPS)
    close(L11, Lw[..., :7, :7], 1e-13)
    close(L21, Lw[..., 7:, :7], 1e-13)
    close(d, dw[..., :7], 1e-13)
    # the update is the complement the remaining columns factor
    L22, d2, _ = tdm._ldl_plain(U, EPS)
    close(L22, Lw[..., 7:, 7:], 1e-12)
    close(d2, dw[..., 7:], 1e-12)
    assert int(p) == 0 and int(f) == 0


# ---------------------------------------------------------------------------
# card
# ---------------------------------------------------------------------------

def plain(F, eps=EPS):
    """The kernel's oracle: the plain recursion on the CPU."""
    return tdm._ldl_plain(F.cpu(), eps)


def check_leaf(got, want, dtype):
    L, d, p = got
    Lw, dw, pw = want
    close(L, Lw, RTOL[dtype])
    close(d, dw, RTOL[dtype])
    assert int(p) == int(pw)
    assert torch.equal(torch.triu(L, 1).cpu(), torch.zeros_like(Lw))
    assert torch.equal(torch.diagonal(L, dim1=-2, dim2=-1).cpu(),
                       torch.ones_like(dw))


@pytest.mark.card
@pytest.mark.parametrize("n", [1, 2, 7, 16, 31, LEAF])
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_matches_the_plain_recursion(card, dtype, n):
    """(B, n, n) and (S, B, n, n) batches, junk above the diagonal, the
    tiny pivots clamped with their sign, a zero row; the counts equal."""
    for shape, seed in (((37, n, n), 10), ((3, 5, n, n), 11)):
        F = symmetric(shape, dtype, seed + n)
        junk = torch.triu(torch.full_like(F, 1e30), 1)
        got = cuda_ldl.ldl_leaf((torch.tril(F) + junk).to(card), EPS)
        torch.cuda.synchronize()
        want = plain(F)
        check_leaf(got, want, dtype)
        assert int(want[2]) == shape[-3] * (np.prod(shape[:-3]) or 1) \
            + (n > 3)
        assert float(got[1][..., 0].real.abs().max()) == pytest.approx(EPS)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_on_views_of_a_front_buffer(card, dtype):
    """The diagonal block of a (S, B, NF, NF) front buffer, whose batch
    axes collapse (no copy), and one whose do not (copied), written into
    views of larger outputs, which keep what lies outside them."""
    n, NF = 29, 41
    buf = symmetric((2, 6, NF, NF), dtype, 12).to(card)
    for F in (buf[..., :n, :n], buf[:, 1:, 3:3 + n, 3:3 + n]):
        Lbig = torch.full(F.shape[:-2] + (NF, NF), 5.0, dtype=dtype,
                          device=card)
        dbig = torch.full(F.shape[:-2] + (NF,), 5.0, dtype=dtype,
                          device=card)
        cnt = torch.full((), 3, dtype=torch.int64, device=card)
        L, d, p = cuda_ldl.ldl_leaf(F, EPS, Lbig[..., 1:1 + n, :n],
                                    dbig[..., 2:2 + n], cnt)
        assert p is cnt
        Lw, dw, pw = plain(F)
        check_leaf((L, d, p - 3), (Lw, dw, pw), dtype)
        assert bool((Lbig[..., 1:1 + n, n:] == 5).all())
        assert bool((Lbig[..., 0, :] == 5).all())
        assert bool((dbig[..., :2] == 5).all())
        assert bool((dbig[..., 2 + n:] == 5).all())


@pytest.mark.card
@pytest.mark.parametrize("n", [33, 65, 100])
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128,
                                   torch.complex64])
def test_batched_ldl_above_the_leaf(card, dtype, n):
    """``batched_ldl`` on the card (splits, then the kernel) against the
    plain recursion; one ``solver.ldl_leaf_kernels`` a leaf and no plain
    base case."""
    F = symmetric((2, 3, n, n), dtype, 13 + n)
    profiling.tracing(True)
    got = tdm.batched_ldl(F.to(card), EPS)
    torch.cuda.synchronize()
    counters = profiling.trace_report()["counters"]
    assert counters == {"solver.ldl_leaf_kernels": {33: 2, 65: 3,
                                                    100: 4}[n]}
    check_leaf(got, plain(F), dtype)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_captured_kernel_replays_with_a_new_eps(card, dtype):
    """A graph of the kernel (the count zeroed in it) replayed with a new
    eps in its 0-d tensor equals the eager kernel at that eps bit for bit;
    the new eps clamps pivots the old one did not."""
    n = 24
    F = symmetric((50, n, n), dtype, 14, tiny=False).to(card)
    for i in (5, 9):
        F[:, i, :] = 0
        F[:, :, i] = 0
    F[:, 5, 5] = 1e-7      # clamped at eps 1e-6, not at 1e-8
    F[:, 9, 9] = -1e-9     # clamped at both
    eps = torch.full((), 1e-8, dtype=dtype.to_real(), device=card)
    L = torch.empty_like(F)
    d = F.new_empty(F.shape[:-1])
    cnt = torch.zeros((), dtype=torch.int64, device=card)

    def body():
        cnt.zero_()
        cuda_ldl.ldl_leaf(F, eps, L, d, cnt)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body()
    g.replay()
    torch.cuda.synchronize()
    assert int(cnt) == 50
    eps.fill_(1e-6)
    g.replay()
    want = cuda_ldl.ldl_leaf(F, 1e-6)
    torch.cuda.synchronize()
    assert int(cnt) == int(want[2]) == 100
    assert torch.equal(L, want[0]) and torch.equal(d, want[1])


@pytest.mark.card
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_device_factorization_against_the_cpu(card, dtype):
    """A whole ``ldlt(method="device")`` (the factor graph on the card):
    f64 on laplace2d(64), c128 on helmholtz(64), against the same
    factorization on the CPU (rtol 1e-10) and scipy's solution; the card
    takes the kernel at every leaf and the CPU the plain recursion."""
    k = 64
    M = laplace2d(k) if dtype == np.float64 else helmholtz(k)
    rng = np.random.default_rng(15)
    b = rng.standard_normal(k * k).astype(dtype)
    x_ref = spla.spsolve(M.tocsc().astype(dtype), b)
    sols, counts = {}, {}
    for dev in ("cpu", card):
        be = ht.backend_auto(1, device=dev)
        A = ht.DistSparseMatrix.from_scipy(M, be, dtype=dtype)
        profiling.reset_trace()
        profiling.tracing(True)
        F = ht.ldlt(A, method="device")
        x = F.solve(ht.DistVector.from_global(b, be, dtype=dtype))
        sols[str(dev)] = x.to_numpy()
        profiling.tracing(False)
        counts[str(dev)] = profiling.trace_report()["counters"]
        counts[str(dev)]["n_perturbed"] = F.n_perturbed
        F.finalize()
        ht.clear_plan_cache("device_mf")
    got, want = sols[str(card)], sols["cpu"]
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert np.abs(got - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    assert counts[str(card)]["n_perturbed"] == counts["cpu"]["n_perturbed"]
    assert counts[str(card)].get("solver.ldl_leaf_kernels", 0) > 0
    assert "solver.ldl_leaf_plain" not in counts[str(card)]
    assert counts["cpu"].get("solver.ldl_leaf_plain", 0) > 0
    assert "solver.ldl_leaf_kernels" not in counts["cpu"]


# ---- the benchmark's size -----------------------------------------------------

LEAF_EPS = 1e-10
# the replayed cases, (blocks, columns) in c128: helmholtz2d-512's widest
# level (27,647 fronts of 16 columns) and a 32-column leaf of its upper
# levels
LEAF_REPLAYED = [(27647, 16), (64, 32)]


def leaf_blocks(B, n, dtype, seed):
    """B seeded n × n blocks on the card, symmetric with the plain
    transpose, diagonally dominant with alternating signs; in the first,
    entry (0, 0) is 1e-14 and its row and column zero, a pivot the clamp
    takes."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((B, n, n))
    if dtype.is_complex:
        M = M + 1j * rng.standard_normal((B, n, n))
    M = M + np.swapaxes(M, 1, 2) + 3 * n * np.diag(
        np.where(np.arange(n) % 2, -1.0, 1.0))
    M[0, 0, :] = 0
    M[0, :, 0] = 0
    M[0, 0, 0] = 1e-14
    return torch.from_numpy(M).to(dtype=dtype, device="cuda")


@pytest.fixture(scope="module")
def helmholtz256():
    """ldlt(method="device", spd=False) of helmholtz(256) in c128 on S = 1
    and its solve, with the host fallback's warning an error, the leaf
    kernel's launch counter and the recorder's counters set to 0 just
    before and read just after and each leaf's shape noted as it passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    H = helmholtz(256)
    rng = np.random.default_rng(17)
    bh = rng.standard_normal(H.shape[0]) + 1j * rng.standard_normal(
        H.shape[0])
    be = ht.backend_auto(1, dtype=np.complex128, device="cuda")
    A = ht.DistSparseMatrix.from_scipy(H, be)
    b = ht.DistVector.from_global(bh, be)
    leaf, shapes = tdm._ldl_leaf, set()

    def noted(F, *args):
        shapes.add((int(np.prod(F.shape[:-2])), F.shape[-1]))
        return leaf(F, *args)

    with warnings.catch_warnings():
        warnings.filterwarnings("error",
                                message="device multifrontal unavailable")
        cuda_ldl.ldl_leaf.launches = 0
        profiling.reset_trace()
        profiling.tracing(True)
        with dc.patched(tdm, _ldl_leaf=noted):
            F = ht.ldlt(A, method="device", spd=False)
            x = F.solve(b).to_numpy()
        torch.cuda.synchronize()
        profiling.tracing(False)
    out = {"counters": profiling.trace_report()["counters"],
           "launches": cuda_ldl.ldl_leaf.launches, "shapes": sorted(shapes),
           "device": isinstance(F, tdm.DeviceFactorization),
           "residual": np.linalg.norm(H @ x - bh) / np.linalg.norm(bh)}
    profiling.reset_trace()
    del F
    ht.clear_plan_cache("device_mf")
    return out


@pytest.mark.card
def test_helmholtz_factorization_takes_the_kernel_at_every_leaf(
        helmholtz256):
    """Its launches equal ``solver.ldl_leaf_kernels``; no leaf takes the
    plain recursion; residual <= 1e-10."""
    got = helmholtz256
    assert got["device"] and got["launches"] > 0
    assert got["launches"] == got["counters"].get("solver.ldl_leaf_kernels")
    assert "solver.ldl_leaf_plain" not in got["counters"]
    assert got["residual"] <= 1e-10


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_at_each_leaf_shape_of_helmholtz(card, helmholtz256, dtype):
    """The kernel at every leaf shape of that factorization against the
    plain recursion on the card: L and d within RTOL of their largest
    entry (at least 1 here), the same clamped pivots, a unit diagonal and
    zeros above it."""
    for i, (B, n) in enumerate(helmholtz256["shapes"]):
        F = leaf_blocks(B, n, dtype, 17 + i)
        eps = torch.full((), LEAF_EPS, dtype=dtype.to_real(), device=card)
        want = tuple(t.cpu() for t in tdm._ldl_plain(F, eps))
        check_leaf(cuda_ldl.ldl_leaf(F, eps), want, dtype)


@pytest.mark.card
@pytest.mark.parametrize("B, n", LEAF_REPLAYED)
def test_captured_kernel_equals_the_captured_plain_recursion(card, B, n):
    """The kernel and the plain recursion, each captured as a CUDA graph
    (as the factor graph holds them) and replayed, in c128: L and d within
    1e-12, the same clamped pivots."""
    F = leaf_blocks(B, n, torch.complex128, 170 + n)
    eps = torch.full((), LEAF_EPS, dtype=torch.float64, device=card)
    got = []
    for fn in (lambda: cuda_ldl.ldl_leaf(F, eps),
               lambda: tdm._ldl_plain(F, eps)):
        fn()
        torch.cuda.synchronize()
        g, out, _ = graphs.record(fn, card)
        g.replay()
        got.append(out)
    torch.cuda.synchronize()
    (Lk, dk, pk), (Lp, dp, pp) = got
    close(Lk, Lp, RTOL[torch.complex128])
    close(dk, dp, RTOL[torch.complex128])
    assert int(pk) == int(pp)
