"""The SpMV kernels on the card at the main path's sizes: K1 (DIA,
``ops/cuda_dia.py``), K2 (ELL with its COO tail, and its gather mode,
``ops/cuda_ell.py``) and K3 (resident-x ELL, ``ops/cuda_ell_resident.py``),
each against its plain version, in f32 and f64 and, through the public
API, in c64 and c128; and the main path's A @ x, CG and host solves with
the launch counters read around them.

The matrices have 10^6 rows (laplace2d(1000), the random 10^6 x 8 matrix,
a power law with a COO tail, a wide-span pattern) or are the ridge normal
matrix N = AᵀA + 10⁻²I of a 10^6 x 16384 banded design; all are made
from fixed seeds. This file imports no JAX, so the card runs it with

    python -m pytest --noconftest -m card tests/test_torch_card_spmv.py

Every test needs a CUDA device and skips without one.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import hpclinalg_torch as ht
from hpclinalg_torch.ops import cuda_dia, cuda_ell
from hpclinalg_torch.ops import cuda_ell_resident as k3
from hpclinalg_torch.ops import spmv as spmv_mod
from hpclinalg_torch.tools import dist_checks as dc
from hpclinalg_torch.tools.matrices import (RIDGE_LAMBDA, banded_design,
                                            complex_values, helmholtz,
                                            laplace2d, power_law, random_8,
                                            random_cols, wide_span)

SEED = 0
N = 1_000_000           # rows of the SpMV matrices (laplace2d(K): N = K^2)
K = 1000
D = 8_000_000           # destinations of the gather-mode checks
RIDGE_M, RIDGE_N = 1_000_000, 16_384
RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}
# products held to the rtol of their parts' type
CPLX_RTOL = {torch.complex128: 1e-12, torch.complex64: 1e-5}
CPLX = {"c128": (torch.complex128, np.complex128),
        "c64": (torch.complex64, np.complex64)}
REAL = {"f32": (torch.float32, np.float32), "f64": (torch.float64, np.float64)}
CAP_ROWS = 300_000      # rows of the at-the-cap matrices (random_cols)
# K3's cases: (matrix, S, dtype); the last stages a gathered x at the cap
K3_CASES = [("N", 1, "f64"), ("N", 1, "f32"), ("N", 4, "f64"),
            ("N", 4, "f32"), ("A", 1, "f64"), ("at_cap", 1, "f64")]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def mats(card):
    Ab, _ = banded_design(RIDGE_M, RIDGE_N, SEED + 8)
    N_sc = (Ab.T @ Ab + RIDGE_LAMBDA * sp.eye(RIDGE_N)).tocsr()
    N_sc.sort_indices()
    return {"L1000": laplace2d(K), "R8": random_8(N, SEED + 1),
            "PL": power_law(N, SEED + 2), "A": Ab, "N": N_sc}


@pytest.fixture(scope="module")
def stream(card):
    """The vectors drawn from one generator in a fixed order: x, the
    gather's sources (3 % dead), then one x for each of K3's cases and one
    for the matrix one slot group over the cap."""
    rng = np.random.default_rng(SEED)
    xh = rng.standard_normal(N)
    src = rng.integers(0, N, D).astype(np.int32)
    src[rng.random(D) < 0.03] = -1
    g_cap = k3.smem_cap(card) // 8 // 8 * 8
    ncols = [RIDGE_N] * 5 + [g_cap - 8, g_cap]
    return {"x": xh, "src": src, "g_cap": g_cap,
            "k3_x": [rng.standard_normal(n) for n in ncols]}


@pytest.fixture(scope="module")
def cstream(card):
    """The complex checks' z and w (10^6 each) and a real x, in order."""
    rng = np.random.default_rng(SEED + 40)
    zh = cplx_vec(rng, N)
    wh = cplx_vec(rng, N)
    return {"z": zh, "w": wh, "x": rng.standard_normal(N)}


def cplx_vec(rng, n):
    return rng.standard_normal(n) + 1j * rng.standard_normal(n)


def close(got, want, rtol):
    """max |got - want| <= rtol max |want|."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert err <= rtol * max(scale, 1e-300), (err, rtol, scale)


def held_to(ref, got, dt, scale=None):
    """``got`` against the complex128 reference within CPLX_RTOL[dt] of
    max |ref|, or of ``scale`` (a sum's terms' magnitudes)."""
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    s = float(np.abs(ref).max()) if scale is None else scale
    assert float(np.abs(got - ref).max()) <= CPLX_RTOL[dt] * s


def rounded(a, npdt):
    """``a`` rounded to npdt and widened back to complex128: the inputs a
    run in npdt sees, for a reference computed in complex128."""
    if sp.issparse(a):
        return a.astype(npdt).astype(np.complex128)
    return np.asarray(a).astype(npdt).astype(np.complex128)


def engine_inputs(A, x):
    """The SpMV plan of A @ x and the gathered x its engine reads."""
    plan = spmv_mod.get_spmv_plan(A, x)
    return (plan,) + spmv_mod.gathered(plan, x.data)


def dia_args(A, plan, g, pad_to):
    return (spmv_mod._dia_values(A, plan), g, plan.offsets, plan.bias_lo,
            plan.bias_hi, pad_to)


def ell_call(plan, Md, g, pad_to):
    """K2's and K3's arguments as A @ x passes them: (args, K2 keywords,
    K3 keywords)."""
    args, kw, windows = spmv_mod.ell_kernel_args(Md, plan, g, pad_to)
    return args, kw, dict(kw, windows=windows)


def misaligned(t):
    """A copy of ``t`` whose data starts one item past the allocator's
    16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def counted(fn):
    """fn() with the launch counters set to 0 just before and read just
    after: (result, {kernel: launches})."""
    torch.cuda.synchronize()
    dc.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dc.launch_counts()


def k1_held(args, vector):
    """K1 on ``args`` equals its plain version bit for bit, and the kernel
    that ran (as the wrapper records it at the launch) is dia_vec where
    dia_vector_width gives 16 bytes (``vector``), else dia_scalar."""
    cuda_dia.dia_spmv.kernel = None
    yk = cuda_dia.dia_spmv(*args)
    ran = cuda_dia.dia_spmv.kernel
    yp = cuda_dia.dia_spmv_plain(*args)
    torch.cuda.synchronize()
    width = cuda_dia.dia_vector_width(args[0], args[1], yk)
    assert torch.equal(yk, yp)
    assert (width > 1) == vector
    assert ran == ("dia_vec" if vector else "dia_scalar")


@pytest.mark.card
def test_kernels_and_host_engines_build(card):
    from hpclinalg_torch.solver import native
    from hpclinalg_torch.utils.warmup import build_kernels

    build_kernels()
    assert native.load_mf() is not None and native.load_sym() is not None \
        and native.load_ell() is not None


# ---- K1 ---------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("dt", list(REAL))
@pytest.mark.parametrize("S", [1, 4])
def test_k1_laplace(card, mats, stream, S, dt):
    """laplace2d(1000) takes the DIA engine; its 16-byte kernel equals the
    plain version bit for bit, and A @ x equals scipy's."""
    tdt, npdt = REAL[dt]
    be = ht.backend_auto(S, dtype=npdt, device=card)
    A = ht.DistSparseMatrix.from_scipy(mats["L1000"], be)
    x = ht.DistVector.from_global(stream["x"], be)
    plan, g, pad_to = engine_inputs(A, x)
    assert plan.offsets is not None
    k1_held(dia_args(A, plan, g, pad_to), True)
    close((A @ x).to_numpy(), mats["L1000"] @ stream["x"].astype(npdt),
          RTOL[tdt])


@pytest.mark.card
@pytest.mark.parametrize("dt", list(REAL))
def test_k1_wide_span(card, stream, dt):
    """Offsets ±3·10⁵ (three staged pieces) on the 16-byte kernel."""
    be = ht.backend_auto(1, dtype=REAL[dt][1], device=card)
    A = ht.DistSparseMatrix.from_scipy(wide_span(N), be)
    x = ht.DistVector.from_global(stream["x"], be)
    plan, g, pad_to = engine_inputs(A, x)
    assert plan.offsets == (-(3 * N // 10), 0, 3 * N // 10)
    k1_held(dia_args(A, plan, g, pad_to), True)


@pytest.mark.card
def test_k1_scalar_kernel_at_an_odd_lrow(card, stream):
    """laplace2d(999)'s table cut to its 998001 rows takes dia_scalar."""
    L999 = laplace2d(K - 1)
    be = ht.backend_auto(1, dtype=np.float64, device=card)
    A = ht.DistSparseMatrix.from_scipy(L999, be)
    x = ht.DistVector.from_global(stream["x"][: L999.shape[0]], be)
    plan, g, pad_to = engine_inputs(A, x)
    args = dia_args(A, plan, g, pad_to)
    k1_held((args[0][:, :, : L999.shape[0]].contiguous(),) + args[1:], False)


@pytest.mark.card
def test_k1_scalar_kernel_with_g_off_16_bytes(card, mats, stream):
    """laplace2d(1000) in f32 with a gathered x 4 bytes off 16."""
    be = ht.backend_auto(1, dtype=np.float32, device=card)
    A = ht.DistSparseMatrix.from_scipy(mats["L1000"], be)
    x = ht.DistVector.from_global(stream["x"], be)
    args = dia_args(A, *engine_inputs(A, x))
    k1_held((args[0], misaligned(args[1])) + args[2:], False)


# ---- K2 ---------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("dt", list(REAL))
@pytest.mark.parametrize("name", ["R8", "PL"])
def test_k2(card, mats, stream, name, dt):
    """The random and the power-law matrix (with a COO tail) take the ELL
    engine; K2 within rtol of its plain version (the tail's atomics sum
    in no fixed order)."""
    tdt, npdt = REAL[dt]
    be = ht.backend_auto(1, dtype=npdt, device=card)
    A = ht.DistSparseMatrix.from_scipy(mats[name], be)
    x = ht.DistVector.from_global(stream["x"], be)
    plan, g, pad_to = engine_inputs(A, x)
    assert plan.ell and (plan.ell_Tpad > 0 or name == "R8")
    args, kw, _ = ell_call(plan, A, g, pad_to)
    close(cuda_ell.ell_spmv(*args, **kw), cuda_ell.ell_spmv_plain(*args),
          RTOL[tdt])


@pytest.mark.card
@pytest.mark.parametrize("dt", list(REAL))
def test_k2_four_shards_in_one_launch(card, stream, dt):
    """A power law of 10^5 rows on S = 4, each shard with its own rows and
    tail."""
    tdt, npdt = REAL[dt]
    PL4 = power_law(N // 10, SEED + 3)
    be = ht.backend_auto(4, dtype=npdt, device=card)
    A = ht.DistSparseMatrix.from_scipy(PL4, be)
    x = ht.DistVector.from_global(stream["x"][: PL4.shape[1]], be)
    plan, g, pad_to = engine_inputs(A, x)
    args, kw, _ = ell_call(plan, A, g, pad_to)
    assert plan.ell_Tpad > 0
    close(cuda_ell.ell_spmv(*args, **kw), cuda_ell.ell_spmv_plain(*args),
          RTOL[tdt])


@pytest.mark.card
@pytest.mark.parametrize("dt", list(REAL))
def test_gather_mode(card, stream, dt):
    """8·10^6 random slots, 3 % dead, bit for bit."""
    cuda_ell.check_index("gather src", stream["src"], N, dead_below_zero=True)
    src = torch.from_numpy(stream["src"]).to(card)[None]
    xg = torch.from_numpy(stream["x"]).to(card, REAL[dt][0])[None]
    assert torch.equal(cuda_ell.gather(xg, src), cuda_ell.gather_plain(xg, src))


@pytest.mark.card
@pytest.mark.parametrize("case", ["odd_length", "source_off_16",
                                  "two_shards_odd_width"])
def test_gather_mode_edges(card, stream, case):
    """An odd length, a source table 4 bytes off 16, two shards of an odd
    width: bit for bit in f64."""
    src = torch.from_numpy(stream["src"]).to(card)[None]
    x2 = torch.from_numpy(stream["x"]).to(card, torch.float64) \
        .expand(2, N).contiguous()
    half = D // 2 - 1
    xa, sa = {"odd_length": (x2[:1], src[:, : D - 3]),
              "source_off_16": (x2[:1], src[:, 1:]),
              "two_shards_odd_width": (x2, src[0, : 2 * half].view(2, half))
              }[case]
    assert torch.equal(cuda_ell.gather(xa, sa), cuda_ell.gather_plain(xa, sa))


# ---- the main path through the public API, f64 ------------------------------

@pytest.fixture(scope="module")
def main_path(card, mats, stream):
    """laplace2d(1000) and the random matrix on S = 1, f64, with their plans
    built and a first use of each call made (set-up, outside the counts)."""
    be = ht.backend_auto(1, dtype=np.float64, device=card)
    A = ht.DistSparseMatrix.from_scipy(mats["L1000"], be)
    Ar = ht.DistSparseMatrix.from_scipy(mats["R8"], be)
    bh = np.random.default_rng(SEED + 3).standard_normal(N)
    b = ht.DistVector.from_global(bh, be)
    xv = ht.DistVector.from_global(stream["x"], be)
    A @ xv, Ar @ xv
    dc.api_cg(A, b, 3)
    torch.cuda.synchronize()
    return be, A, Ar, b, xv


@pytest.mark.card
def test_main_path_cg(card, mats, stream, main_path):
    """A @ x against scipy; 200 CG steps launch K1 once a step at least and
    lower the residual; their iterates equal those with K1's plain version
    in its place to rtol 1e-9."""
    be, A, _, b, xv = main_path
    y, c = counted(lambda: (A @ xv).to_numpy())
    close(y, mats["L1000"] @ stream["x"], 1e-12)
    (xk, rk), c = counted(lambda: dc.api_cg(A, b, 200))
    assert c["dia"] >= 200
    rn, bn = float(rk.norm()), float(b.norm())
    assert np.isfinite(rn) and rn < bn
    with dc.patched(spmv_mod, dia_spmv=cuda_dia.dia_spmv_plain):
        xp, _ = dc.api_cg(A, b, 200)
    torch.cuda.synchronize()
    close(xk.data, xp.data, 1e-9)


@pytest.mark.card
def test_main_path_random(card, mats, stream, main_path):
    """A @ x on the random matrix against scipy, through K2 and its gather
    mode."""
    _, _, Ar, _, xv = main_path
    y, c = counted(lambda: (Ar @ xv).to_numpy())
    close(y, mats["R8"] @ stream["x"], 1e-12)
    assert c["ell"] > 0 and c["gather"] > 0


@pytest.mark.card
def test_main_path_host_solves(card, main_path):
    """ldlt(laplace2d(100)).solve on the native engine; ht.solve with new
    values a backslash-cache hit; lu on unsymmetric values."""
    be = main_path[0]
    L100 = laplace2d(100)
    A100 = ht.DistSparseMatrix.from_scipy(L100, be)
    b100h = np.random.default_rng(SEED + 4).standard_normal(L100.shape[0])
    b100 = ht.DistVector.from_global(b100h, be)
    F = ht.ldlt(A100)
    x100 = F.solve(b100).to_numpy()
    assert F.native is not None
    assert np.linalg.norm(L100 @ x100 - b100h) <= 1e-12 * np.linalg.norm(b100h)
    ht.clear_plan_cache("backslash")
    ht.solve(A100, b100)
    cache = ht.BackslashCache._cache()
    F1 = next(iter(cache.values()))
    L100b = (2.0 * L100 + sp.eye(L100.shape[0])).tocsr()
    A100b = A100.with_values(ht.DistSparseMatrix.from_scipy(L100b, be).nzval)
    xb = ht.solve(A100b, b100).to_numpy()
    assert len(cache) == 1 and next(iter(cache.values())) is F1
    assert F1.A is A100b
    assert np.linalg.norm(L100b @ xb - b100h) <= 1e-12 * np.linalg.norm(b100h)
    ht.clear_plan_cache("backslash")
    Lu = L100.copy()
    Lu.data = Lu.data * (1.0 + 0.2 * np.random.default_rng(SEED + 5)
                         .random(Lu.nnz))
    xu = ht.lu(ht.DistSparseMatrix.from_scipy(Lu, be)).solve(b100).to_numpy()
    assert np.linalg.norm(Lu @ xu - b100h) <= 1e-10 * np.linalg.norm(b100h)


# ---- K3 ---------------------------------------------------------------------

@pytest.mark.card
@pytest.mark.parametrize("i", range(len(K3_CASES)),
                         ids=[f"{m}-S{S}-{d}" for m, S, d in K3_CASES])
def test_k3(card, mats, stream, i):
    """The ridge N, the design A and a gathered x at the shared-memory cap
    take the resident engine; K3 within rtol of its plain version and of
    K2 on the same tables; at the cap also with one-entry loads."""
    name, S, dt = K3_CASES[i]
    tdt, npdt = REAL[dt]
    M = random_cols(CAP_ROWS, stream["g_cap"] - 8, 4, SEED + 6) \
        if name == "at_cap" else mats[name]
    be = ht.backend_auto(S, dtype=npdt, device=card)
    Md = ht.DistSparseMatrix.from_scipy(M, be)
    x = ht.DistVector.from_global(stream["k3_x"][i], be)
    plan, g, pad_to = engine_inputs(Md, x)
    assert plan.engine(tdt) == "resident"
    args, kw2, kw3 = ell_call(plan, Md, g, pad_to)
    y3 = k3.ell_resident_spmv(*args, **kw3)
    yp = k3.ell_resident_spmv_plain(*args)
    y2 = cuda_ell.ell_spmv(*args, **kw2)
    torch.cuda.synchronize()
    close(y3, yp, RTOL[tdt])
    close(y3, y2, RTOL[tdt])
    if name == "at_cap":
        y1 = k3.ell_resident_spmv(misaligned(args[0]), *args[1:], **kw3)
        close(y1, yp, RTOL[tdt])


@pytest.mark.card
def test_k3_over_the_cap_takes_k2(card, stream):
    """One slot group past the cap: A @ x takes K2, not K3 (f32 would fit:
    resident), and equals scipy's."""
    M = random_cols(CAP_ROWS, stream["g_cap"], 4, SEED + 7)
    be = ht.backend_auto(1, dtype=np.float64, device=card)
    Md = ht.DistSparseMatrix.from_scipy(M, be)
    xh = stream["k3_x"][6]
    x = ht.DistVector.from_global(xh, be)
    plan = spmv_mod.get_spmv_plan(Md, x)
    Md @ x
    y, c = counted(lambda: (Md @ x).to_numpy())
    assert plan.engine(torch.float64) == "ell"
    assert plan.engine(torch.float32) == "resident"
    assert c["ell"] == 1 and c["resident"] == 0
    close(y, M @ xh, 1e-12)


# ---- complex values, each kernel in one launch ------------------------------

@pytest.mark.card
@pytest.mark.parametrize("dt", list(CPLX))
@pytest.mark.parametrize("S", [1, 4])
def test_k1_complex_helmholtz(card, cstream, S, dt):
    """Helmholtz(1000): K1's dia_vec in one launch on complex values
    against its plain version; H @ z, the conjugating z.dot(w), norm, an
    axpy and (c128) H.H @ z against numpy, K1 launched once a product."""
    tdt, npdt = CPLX[dt]
    H = helmholtz(K)
    zh, wh = cstream["z"], cstream["w"]
    be = ht.backend_auto(S, dtype=npdt, device=card)
    Hd = ht.DistSparseMatrix.from_scipy(H, be)
    z = ht.DistVector.from_global(zh, be)
    w = ht.DistVector.from_global(wh, be)
    plan, g, pad_to = engine_inputs(Hd, z)
    args = dia_args(Hd, plan, g, pad_to)
    cuda_dia.dia_spmv.kernel = None
    c0 = cuda_dia.dia_spmv.launches
    yk = cuda_dia.dia_spmv(*args)
    assert plan.offsets is not None and cuda_dia.dia_spmv.kernel == "dia_vec"
    assert cuda_dia.dia_kernel(args[0], g, yk) == "dia_vec"
    assert cuda_dia.dia_spmv.launches == c0 + 1
    assert yk.dtype == tdt
    close(yk, cuda_dia.dia_spmv_plain(*args), CPLX_RTOL[tdt])
    alpha = 0.75 - 0.5j

    def ops():
        out = {"y": (Hd @ z).to_numpy(), "dot": complex(z.dot(w)),
               "norm": float(z.norm()), "axpy": (z * alpha + w).to_numpy()}
        if tdt == torch.complex128:
            out["yH"] = (Hd.H @ z).to_numpy()
        return out
    got, c = counted(ops)
    Hr, zr, wr = rounded(H, npdt), rounded(zh, npdt), rounded(wh, npdt)
    held_to(Hr @ zr, got["y"], tdt)
    held_to([np.vdot(zr, wr)], [got["dot"]], tdt,
            scale=float(np.abs(zr) @ np.abs(wr)))
    held_to([np.linalg.norm(zr)], [got["norm"]], tdt)
    held_to(alpha * zr + wr, got["axpy"], tdt)
    if "yH" in got:
        held_to(Hr.conj().T @ zr, got["yH"], tdt)
    assert c["dia"] == (2 if "yH" in got else 1) and c["ell"] == 0


@pytest.mark.card
@pytest.mark.parametrize("dt", list(CPLX))
@pytest.mark.parametrize("name, S", [("random8", 1), ("power_law", 1),
                                     ("power_law_tenth", 4)])
def test_k2_complex(card, mats, cstream, name, S, dt):
    """Seeded complex values on the random and power-law patterns: the ELL
    engine (a tail where the pattern has one), K2 against its plain
    version, A @ z against scipy in one launch."""
    tdt, npdt = CPLX[dt]
    M = {"random8": lambda: complex_values(mats["R8"], SEED + 41),
         "power_law": lambda: complex_values(mats["PL"], SEED + 42),
         "power_law_tenth": lambda: complex_values(
             power_law(N // 10, SEED + 3), SEED + 43)}[name]()
    be = ht.backend_auto(S, dtype=npdt, device=card)
    Md = ht.DistSparseMatrix.from_scipy(M, be)
    zs = cstream["z"][: M.shape[1]]
    z = ht.DistVector.from_global(zs, be)
    plan, g, pad_to = engine_inputs(Md, z)
    args, kw, _ = ell_call(plan, Md, g, pad_to)
    assert plan.engine(tdt) == "ell"
    assert (plan.ell_Tpad > 0) == (name != "random8")
    yk = cuda_ell.ell_spmv(*args, **kw)
    assert yk.dtype == tdt
    close(yk, cuda_ell.ell_spmv_plain(*args), CPLX_RTOL[tdt])
    y, c = counted(lambda: (Md @ z).to_numpy())
    held_to(rounded(M, npdt) @ rounded(zs, npdt), y, tdt)
    assert c["ell"] == 1


@pytest.mark.card
def test_mixed_real_and_complex_products(card, mats, cstream):
    """A complex A times a real x and a real R times a complex z: the real
    operand widened, K2's c128 instantiation launched once each."""
    R8 = mats["R8"]
    R8c = complex_values(R8, SEED + 41)
    be = ht.backend_auto(1, dtype=np.complex128, device=card)
    Cd = ht.DistSparseMatrix.from_scipy(R8c, be)
    Rd = ht.DistSparseMatrix.from_scipy(R8, be, dtype=np.float64)
    xr = cstream["x"]
    xd = ht.DistVector.from_global(xr, be, dtype=np.float64)
    zd = ht.DistVector.from_global(cstream["z"], be)
    (y1, y2), c = counted(lambda: ((Cd @ xd).to_numpy(),
                                   (Rd @ zd).to_numpy()))
    assert Rd.dtype == torch.float64 and xd.dtype == torch.float64
    assert c["ell"] == 2
    held_to(R8c @ xr, y1, torch.complex128)
    held_to(R8 @ cstream["z"], y2, torch.complex128)


@pytest.mark.card
@pytest.mark.parametrize("S, dt, want", [(1, "c64", "resident"),
                                         (1, "c128", "ell"),
                                         (4, "c128", "resident")])
def test_k3_complex_on_n(card, mats, cstream, S, dt, want):
    """The ridge N's pattern with complex values: c64 at S = 1 and c128 at
    S = 4 fit K3's cap, c128 at S = 1 does not and takes K2. K2 and K3
    against the plain version; K3 equals K2 bit for bit where there is no
    tail; N @ z against scipy, one launch of the engine's kernel."""
    tdt, npdt = CPLX[dt]
    Nc = complex_values(mats["N"], SEED + 44)
    zs = cstream["z"][: Nc.shape[0]]
    be = ht.backend_auto(S, dtype=npdt, device=card)
    Nd = ht.DistSparseMatrix.from_scipy(Nc, be)
    z = ht.DistVector.from_global(zs, be)
    plan, g, pad_to = engine_inputs(Nd, z)
    assert plan.engine(tdt) == want
    args, kw2, kw3 = ell_call(plan, Nd, g, pad_to)
    yp = cuda_ell.ell_spmv_plain(*args)
    y2 = cuda_ell.ell_spmv(*args, **kw2)
    close(y2, yp, CPLX_RTOL[tdt])
    if want == "resident":
        y3 = k3.ell_resident_spmv(*args, **kw3)
        assert y3.dtype == tdt
        close(y3, yp, CPLX_RTOL[tdt])
        if plan.ell_Tpad == 0:
            assert torch.equal(y3, y2)
    y, c = counted(lambda: (Nd @ z).to_numpy())
    held_to(rounded(Nc, npdt) @ rounded(zs, npdt), y, tdt)
    assert c[want] == 1 and c["dia"] + c["ell"] + c["resident"] == 1


@pytest.mark.card
@pytest.mark.parametrize("dt, seed", [("c128", SEED + 45),
                                      ("c64", SEED + 46)])
def test_k3_complex_at_the_cap(card, cstream, dt, seed):
    """A gathered x of exactly cap // itemsize slots, staged whole by K3,
    with 16-byte loads and (where a load holds more than one entry) with
    one-entry loads; A @ z against scipy through K3."""
    tdt, npdt = CPLX[dt]
    cap = k3.smem_cap(card)
    slots = (cap // tdt.itemsize) // 8 * 8
    M = complex_values(random_cols(CAP_ROWS, slots - 8, 4, seed), seed)
    be = ht.backend_auto(1, dtype=npdt, device=card)
    Md = ht.DistSparseMatrix.from_scipy(M, be)
    zs = cstream["z"][: M.shape[1]]
    z = ht.DistVector.from_global(zs, be)
    plan, g, pad_to = engine_inputs(Md, z)
    args, kw2, kw3 = ell_call(plan, Md, g, pad_to)
    assert plan.engine(tdt) == "resident"
    assert plan.exchange.out_pad * tdt.itemsize <= cap
    assert kw3["windows"].staged == 0
    yp = cuda_ell.ell_spmv_plain(*args)
    close(k3.ell_resident_spmv(*args, **kw3), yp, CPLX_RTOL[tdt])
    if cuda_ell.unit_entries(plan.ell_W, tdt.itemsize) > 1:
        close(k3.ell_resident_spmv(misaligned(args[0]), *args[1:], **kw3),
              yp, CPLX_RTOL[tdt])
    y, c = counted(lambda: (Md @ z).to_numpy())
    held_to(rounded(M, npdt) @ rounded(zs, npdt), y, tdt)
    assert c["resident"] == 1
